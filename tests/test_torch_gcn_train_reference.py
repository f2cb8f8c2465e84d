"""The DGCNN's training step of the port (``learn/train_dgcnn.py`` over
``models/dgcnn.py`` in train mode and ``learn/train.py``'s Adam) against
the benchmark's plain training reference,
``benchmark/reference/gcn_train.py``, on the CPU with seeded random
weights (the configuration's draw, ``draw_variables``), at a small size:
the patches of a noisy icosphere(2) (320 faces), emb_dims 64, batch 8,
3 steps.

The port's patches come from ``extract_mesh_patches`` and its batches
from ``ShardStore.from_patches``, as the benchmark's entry takes them;
the reference gets the same patches and draws its own batch rows and keep
masks by the documented rules. In float64 on both sides the losses agree
within 1e-12 relative (readings 1.5e-15-5.0e-15: the sums of one batch in
other orders), the running statistics within 1e-10 of max(|entry|, 1)
(readings 1.2e-13-2.5e-13) and the parameters within 1e-10 (readings
7.4e-13-2.1e-12; a flipped Adam sign moves a parameter 2 lr, 2e-4). A
redrawn dropout mask or torch's unbiased running variance fails those
bounds by orders of magnitude. In float32 the gradients are
ill-conditioned (a max or a feature neighbour changes its winner under
rounding, and Adam's first update is the gradient's sign), so only the
first loss is held there, within 1e-5 relative: the reference's forward
sums in the port's orders, so it reads 0, where TF32 in the products
moves it 1.5e-3-3e-2.

Also: the training count of ``benchmark/counts/gcn_train.py`` worked out
by hand at one small width; the trainers' four spans once a step and the
step counter; the reference importing nothing of the port or of JAX;
``ShardStore.from_patches`` against a store read from the same arrays
saved as a shard; and, on the card only (``-m cuda``), the steps whose
forward and backward replay CUDA graphs against the eager steps, bit for
bit, also where a caller holds an eager loss of the parameters at the
capture or the parameters move between steps, with the eager steps'
graph-kernel launch counts.
"""

import json
import subprocess
import sys
from itertools import islice
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.counts import gcn, gcn_train as train_counts
from benchmark.entries import gcn_dgcnn_train as entry
from benchmark.gen import pool, shapes
from benchmark.reference import gcn_train as ref
from ngpd_tpu_torch.config import ModelConfig, PatchConfig
from ngpd_tpu_torch.learn import train as ttrain
from ngpd_tpu_torch.learn import train_dgcnn as ttd
from ngpd_tpu_torch.meshproc.patches import MeshPatchBatch, extract_mesh_patches
from ngpd_tpu_torch.meshproc.trimesh import TriMesh
from ngpd_tpu_torch.models import dgcnn as tdgcnn
from ngpd_tpu_torch.models.patch2normal import init_patch2normal
from ngpd_tpu_torch.utils import prof

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = dict(json.loads((ROOT / "benchmark" / "configs" / "gcn_denoiser_dgcnn_train.json")
                         .read_text()), emb_dims=64, batch=8, root=str(ROOT))
STEPS = 3
LOSS_RTOL_64, STATS_TOL_64, PARAM_TOL_64 = 1e-12, 1e-10, 1e-10
LOSS0_RTOL_32 = 1e-5


def _mesh(seed):
    noisy, f, clean = shapes.noisy_icosphere(2, 0.6, 0.3, torch.Generator().manual_seed(seed),
                                             "cpu")
    return {"vertices": noisy, "faces": f, "clean": clean}


def _patches(job):
    gt, _, _ = TriMesh(v=job["clean"], f=job["faces"]).face_data()
    return extract_mesh_patches(TriMesh(v=job["vertices"], f=job["faces"]), gt_normals=gt,
                                cfg=PatchConfig(), device="cpu")


def _port64(patches, variables):
    """The port's STEPS steps in float64 on the store's batches: (losses,
    parameters, statistics) in the reference's order."""
    store = ttd.ShardStore.from_patches([patches], CONFIG["val_fraction"], CONFIG["data_seed"],
                                        device="cpu")
    model = entry.load_model(CONFIG, variables, "cpu").double()
    state = ttrain.new_state(model, CONFIG["learning_rate"], CONFIG["dropout_seed"], "cpu")
    losses = []
    for batch in islice(store.batches("train", CONFIG["batch"]), STEPS):
        _, metrics = ttd.dgcnn_train_step(state, {k: v.double() for k, v in batch.items()})
        losses.append(metrics["loss"])
    flat = [torch.cat([entry.flax_view(model, k).detach().reshape(-1) for k in variables
                       if k.startswith(kind)]) for kind in ("params/", "batch_stats/")]
    return (torch.stack(losses), *flat)


def _errors(got, want):
    return {"loss": float(((got[0] - want[0]).abs() / want[0].abs()).max()),
            "params": float((got[1] - want[1]).abs().max()),
            "stats": float(((got[2] - want[2]).abs() / want[2].abs().clamp(min=1.0)).max())}


def _within(err):
    return (err["loss"] <= LOSS_RTOL_64 and err["params"] <= PARAM_TOL_64
            and err["stats"] <= STATS_TOL_64)


@pytest.fixture(scope="module", params=[5, 2**31 + 11])
def case(request):
    patches = _patches(_mesh(request.param))
    variables = ref.draw_variables(CONFIG, CONFIG["weights_seed"])
    want = ref.train(patches.inputs.double(), patches.y.double(), variables, CONFIG, STEPS)
    return patches, variables, want


def test_the_float64_steps_match_the_reference(case):
    patches, variables, want = case
    err = _errors(_port64(patches, variables), want)
    assert _within(err), err


def test_a_redrawn_dropout_mask_fails(case, monkeypatch):
    patches, variables, want = case

    def redrawn(model, batch, generator, group):
        return model.draw_keep_masks(batch, torch.Generator().manual_seed(12345))

    monkeypatch.setattr(ttd, "draw_local_keep", redrawn)
    err = _errors(_port64(patches, variables), want)
    assert err["loss"] > 1e3 * LOSS_RTOL_64, err


def test_torch_s_unbiased_running_variance_fails(case, monkeypatch):
    patches, variables, want = case
    plain = tdgcnn._bn

    def unbiased(h, bn, training=False, group=None):
        out = plain(h, bn, training, group)
        if training:  # keep n / (n - 1) of the batch's variance, as torch does
            n = h.numel() // h.shape[-1]
            _, var = tdgcnn.batch_stats(h)
            with torch.no_grad():
                bn.running_var.add_((1 - tdgcnn.BN_MOMENTUM) * var / (n - 1))
        return out

    monkeypatch.setattr(tdgcnn, "_bn", unbiased)
    err = _errors(_port64(patches, variables), want)
    assert err["stats"] > 1e3 * STATS_TOL_64, err
    assert err["loss"] <= LOSS_RTOL_64, err


def test_the_float32_first_loss_matches_the_reference():
    traffic = {"shape": "icosphere_mesh", "subdiv": 2, "radius": 0.6, "noise": 0.3, "pool": 1,
               "steps": STEPS}
    job = pool.make_pool(traffic, 2**31 + 5, "cpu")[0]
    system = entry.System(CONFIG, traffic, "cpu")
    out = system.run(job)
    assert all(torch.equal(a, b) for a, b in zip(out, system.run(job)))  # jobs repeat
    numbers = entry.compare(out, entry.reference(CONFIG, traffic, job))
    assert numbers["loss0_rel"] <= LOSS0_RTOL_32, numbers


def test_the_training_count_is_three_forwards_less_the_first_input_gradient():
    p, c = 8, (4, 4, 8, 8, 8, 8)
    convs = 4 * p * (5 * 4 + 4 * 4 + 4 * 8 + 8 * 8 + 8 * 8 + 8 * 8)
    emb = 2 * p * 40 * 16
    head = 2 * (32 * 6 + 6 * 5 + 5 * 4 + 4 * 3)
    forward = convs + emb + head
    assert gcn.dgcnn_flop_per_patch(p, 5, 16, c, (6, 5, 4, 3)) == forward == 19_068
    # Each map's weight and input gradients, as many as its forward; conv1's
    # input gradient (its two maps, 2 x 2 x 8 x 5 x 4) is left out.
    assert train_counts.flop_per_patch(p, 5, 16, c, (6, 5, 4, 3)) == 3 * forward - 640 == 56_564
    cfg = {"patch_nodes": p, "init_dims": 5, "emb_dims": 16, "edge_channels": list(c),
           "head": [6, 5, 4, 3], "batch": 2, "k": 2, "fixed_graph_convs": 3,
           "neighbour_rows": 3}
    work = train_counts.job_work(cfg, {"steps": 3})
    assert work["flop"] == 3 * 2 * 56_564.0 and work["steps"] == 3
    # A step's graph launches: three blocks over the neighbour rows, then
    # three searches each before its block; e.g. the fourth conv's search
    # over 8-wide features (2 x 28 pairs x 8 channels x 2 patches).
    assert [x[0] for x in work["graph"]] == (["edge_block"] * 3
                                             + ["feature_knn", "edge_block"] * 3) * 3
    assert work["graph"][3] == ("feature_knn", 2 * 28 * 8 * 2.0, 2 * 8 * 8 * 4.0 + 2 * 8 * 2 * 4.0)


def _p2n_step(state):
    b, p, k = 4, 16, 4
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randn((b, p, 8), generator=g),
             "nbr_idx": torch.randint(0, p, (b, p, k), generator=g),
             "nbr_mask": torch.ones((b, p, k), dtype=torch.bool),
             "node_mask": torch.ones((b, p), dtype=torch.bool),
             "y": torch.randn((b, 3), generator=g)}
    ttrain.train_step(state, batch)


def _dgcnn_step(state):
    patches = _patches(_mesh(3))
    ttd.dgcnn_train_step(state, {"x": patches.inputs[:4], "y": patches.y[:4]})


def _p2n_state():
    cfg = ModelConfig(hidden=(8, 8, 8, 8, 8, 8, 16, 8, 4), patch_size=16, patch_k=4)
    return ttrain.new_state(init_patch2normal(cfg, 0), 1e-4, 0, "cpu")


def _dgcnn_state():
    return ttrain.new_state(tdgcnn.DGCNN(emb_dims=16), 1e-4, 0, "cpu")


@pytest.mark.parametrize("make,step", [(_p2n_state, _p2n_step), (_dgcnn_state, _dgcnn_step)],
                         ids=["patch2normal", "dgcnn"])
def test_the_four_spans_record_once_a_step_and_the_counter_counts_the_steps(make, step):
    state = make()
    with prof.span("unrecorded"):  # the next recorded span starts afresh
        pass
    before = ttrain.STEPS["train"]
    with profile(activities=[ProfilerActivity.CPU]):
        step(state)
        step(state)
    spans = prof.recorded()["spans"]
    names = ("ngpd.train", "ngpd.train.forward", "ngpd.train.backward", "ngpd.train.optimizer")
    assert {n: spans[n]["count"] for n in names} == dict.fromkeys(names, 2)
    assert ttrain.STEPS["train"] - before == 2 and state.step == 2
    # The backward lies inside the optimizer's span, so its self time is
    # zero_grad and Adam's step alone.
    opt, bwd = spans["ngpd.train.optimizer"], spans["ngpd.train.backward"]
    assert opt["self_ms"] == pytest.approx(opt["host_ms"] - bwd["host_ms"], abs=1e-6)
    assert {r.parent for r in prof._REGISTRY.records if r.name == "ngpd.train.backward"} == {
        "ngpd.train.optimizer"}


def test_the_reference_imports_nothing_of_the_port_or_of_jax():
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.reference import gcn_train\n"
        "cfg = json.loads(sys.argv[1])\n"
        "v = gcn_train.draw_variables(cfg, 1)\n"
        "x = torch.zeros((40, 20, 64)); x[:, 17:] = torch.arange(64.0)\n"
        "gcn_train.train(x + torch.rand((40, 20, 64)) * (torch.arange(20) < 17)[:, None],\n"
        "                torch.randn((40, 3)), v, cfg, 2)\n"
        "banned = ('ngpd_tpu', 'ngpd_tpu_torch', 'jax', 'jaxlib', 'flax')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code, json.dumps(dict(CONFIG, batch=4))],
                         capture_output=True, text=True, check=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_a_store_from_patches_is_the_store_of_the_same_arrays_saved(tmp_path):
    patches = _patches(_mesh(9))
    half = patches.inputs.shape[0] // 2
    parts = [MeshPatchBatch(inputs=patches.inputs[s], rotations=patches.rotations[s],
                            y=patches.y[s], node_mask=patches.node_mask[s])
             for s in (slice(0, half), slice(half, None))]
    paths = []
    for i, part in enumerate(parts):
        paths.append(tmp_path / f"shard{i}.npz")
        np.savez(paths[-1], x=part.inputs.numpy(), y=part.y.numpy())
    read = ttd.ShardStore([str(p) for p in paths], val_fraction=0.15, seed=4, device="cpu")
    mem = ttd.ShardStore.from_patches(parts, val_fraction=0.15, seed=4, device="cpu")
    for split in ("train", "val"):
        for key in ("x", "y"):
            assert np.array_equal(getattr(read, split)[key], getattr(mem, split)[key])
    start = mem.state_dict()
    for _ in range(2):  # two epochs: the permutations continue alike
        for a, b in zip(read.batches("train", 16), mem.batches("train", 16), strict=True):
            assert all(torch.equal(a[k], b[k]) for k in ("x", "y"))
    for a, b in zip(read.sel_blocks("train", 16, 3), mem.sel_blocks("train", 16, 3),
                    strict=True):
        assert np.array_equal(a, b)
    # Set back to where it started, the store draws a fresh store's batches.
    mem.load_state_dict(start)
    fresh = ttd.ShardStore.from_patches(parts, val_fraction=0.15, seed=4, device="cpu")
    for a, b in zip(mem.batches("train", 16), fresh.batches("train", 16), strict=True):
        assert torch.equal(a["x"], b["x"])


def _hold_a_live_loss(model, batch):
    """An eager train-mode forward on the parameters whose loss (and its
    autograd graph) lives on through the steps, the statistics it moved put
    back."""
    saved = [b.clone() for b in model.buffers()]
    keep = model.draw_keep_masks(batch["x"].shape[0], torch.Generator(batch["x"].device))
    held = model(batch["x"], keep=keep).square().mean()
    with torch.no_grad():
        for b, v in zip(model.buffers(), saved):
            b.copy_(v)
    return held


def _move_the_parameters(model):
    """Every parameter and buffer re-allocated in place of its object, as a
    device round trip may do."""
    before = [t.data_ptr() for t in model.parameters()]
    with torch.no_grad():
        for t in (*model.parameters(), *model.buffers()):
            t.data = t.data.clone()
    assert all(a != t.data_ptr() for a, t in zip(before, model.parameters()))


@pytest.mark.cuda
@pytest.mark.parametrize("case,captures", [("plain", 1), ("live_loss", 1), ("moved", 2)])
def test_the_graphed_steps_on_the_card_give_the_eager_steps_bits(monkeypatch, case, captures):
    """Four steps, graphed against eager, bit for bit: as they are; with an
    eager loss of the parameters alive when the first step captures; with
    the parameters re-allocated after the second step (captured again).
    The graph kernels' launch counts of the last three steps agree too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs are captured and replayed on a card")
    from ngpd_tpu_torch.kernels import graph

    dev = torch.device("cuda")
    cfg = dict(CONFIG, emb_dims=1024, batch=32)
    patches = _patches(_mesh(5))
    variables = ref.draw_variables(cfg, cfg["weights_seed"])
    calls = []
    capture = ttrain._capture
    monkeypatch.setattr(ttrain, "_capture", lambda *a: calls.append(1) or capture(*a))

    def steps():
        store = ttd.ShardStore.from_patches([patches], cfg["val_fraction"], cfg["data_seed"],
                                            device=dev)
        model = entry.load_model(cfg, variables, dev)
        state = ttrain.new_state(model, cfg["learning_rate"], cfg["dropout_seed"], dev)
        losses, held, counted = [], None, None
        for i, batch in enumerate(islice(store.batches("train", cfg["batch"]), 4)):
            if i == 0 and case == "live_loss":
                held = _hold_a_live_loss(model, batch)
            if i == 2 and case == "moved":
                _move_the_parameters(model)
            if i == 1:
                counted = dict(graph.LAUNCHES)
            losses.append(ttd.dgcnn_train_step(state, batch)[1]["loss"])
        torch.cuda.synchronize()
        assert held is None or held.grad_fn is not None
        # The model keeps its parameters, the ones the optimizer updates.
        assert [id(p) for p in model.parameters()] == [
            id(p) for g in state.optimizer.param_groups for p in g["params"]]
        assert all(isinstance(p, torch.nn.Parameter) for p in model.parameters())
        launches = {k: graph.LAUNCHES[k] - counted[k] for k in counted}
        return launches, [torch.stack(losses)] + [t.detach().clone()
                                                  for t in model.state_dict().values()]

    graphed_launches, graphed = steps()
    assert len(calls) == captures
    monkeypatch.setattr(ttd, "graphed_forward", lambda state, inputs, keep: state.model)
    eager_launches, eager = steps()
    assert len(calls) == captures
    # three steps' forwards, in train mode: no epilogue
    assert eager_launches == {"feature_knn": 9, "edge_block": 18, "dgcnn_epilogue": 0}
    warm = 3 if case == "moved" else 0  # the second capture's warm-up forwards ran too
    assert graphed_launches == {k: n + warm * n // 3 for k, n in eager_launches.items()}
    assert all(torch.equal(a, b) for a, b in zip(graphed, eager))
