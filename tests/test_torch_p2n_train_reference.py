"""Patch2Normal's training step of the port (``learn/train.py::train_step``
over ``models/patch2normal.py`` in train mode, Adam) against the
benchmark's plain training reference, ``benchmark/reference/p2n_train.py``,
on the CPU with seeded random weights (the configuration's draw,
``p2n_normals.draw_variables``), at a small size: the MD patches of a
clean 3,025-point roof (55^2) made noisy as ``make-dataset`` makes them,
hidden widths 16-64, 16-node patches in a ball of 2.1 (so that most
patches have fewer than 16 valid nodes and most nodes fewer than 12 valid
edges: every mask and its gradient takes part), batch 8, 5 steps.

The port's data set comes from ``process_cloud`` and ``PatchDataset``
(``from_arrays``), as the benchmark's entry takes it; the reference builds
its own from the same clean cloud and draws its own batch rows and keep
masks by the documented rules. On the CPU the two data sets are equal bit
for bit. In float64 on both sides (the data set cast after it is built)
the losses agree within 1e-12 relative (readings 0-1.6e-15: the sums of a
batch in other orders), the running statistics within 1e-10 of
max(|entry|, 1) (readings 0 after one step, 1.9e-12 after five) and the
parameters within 1e-10 (readings 2.8e-16 after one step, 1.4e-11 after
five, where Adam divides small moments; a flipped Adam sign moves a
parameter 2 lr, 2e-3). A redrawn dropout mask, statistics over every node
where they are over the valid ones, and an edge mean over every edge
fail those bounds by orders of magnitude. In float32 the first loss
agrees within 1e-6 relative (it reads 0: the same data and the same sums
in the same orders; TF32 products move it 3.1e-3), and the parameters
after the first step lie within 1e-3 of the reference's, over the norm
of the reference's change from the start (reading 8.9e-7: Adam's first
update is about the gradient's sign, which rounding flips only where a
gradient is near 0; the TF32 control reads 0.126).

Also: ``PatchDataset.from_arrays`` against the data set read from the
same arrays saved as shards, and the batch span and the graph counter on
the CPU. ``benchmark/tests/test_bench_p2n_train.py`` holds the cell: its
count, its comparison on planted faults, its readers, and the reference
importing nothing of the port or of JAX.
"""

import json
from itertools import islice
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.entries import p2n_train as entry
from benchmark.gen import shapes
from benchmark.reference import p2n_normals, p2n_train as ref
from ngpd_tpu_torch.config import PatchConfig
from ngpd_tpu_torch.core.noise import draw_noise
from ngpd_tpu_torch.learn import train as ttrain
from ngpd_tpu_torch.learn.dataset import KEYS, PatchDataset, process_cloud
from ngpd_tpu_torch.models import edgeconv as tedge
from ngpd_tpu_torch.utils import prof

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = dict(json.loads((ROOT / "benchmark" / "configs" / "patch2normal_md64_train.json")
                         .read_text()),
              hidden=[16, 16, 32, 32, 32, 32, 64, 32, 16], num_nodes=16, k_patch_radius=2.1,
              batch=8)
POINTS, STEPS = 3025, 5
LOSS_RTOL_64, STATS_TOL_64, PARAM_TOL_64 = 1e-12, 1e-10, 1e-10
LOSS0_RTOL_32, FIRST_UPDATE_32 = 1e-6, 1e-3


def _port_arrays(clean, config):
    gen = torch.Generator().manual_seed(config["data_seed"])
    cfg = PatchConfig(num_nodes=config["num_nodes"], patch_k=config["patch_k"],
                      k_patch_radius=config["k_patch_radius"])
    return process_cloud(clean, draw_noise(clean.shape[0], gen), config["noise_level"],
                         config["noise_type"], cfg, device="cpu")


@pytest.fixture(scope="module")
def data():
    clean = shapes.roof_cloud(POINTS, 0.0, torch.Generator().manual_seed(0), "cpu")[0]
    arrays = _port_arrays(clean, CONFIG)
    return arrays, ref.data_set(clean, CONFIG)


def _port(arrays, steps, dtype):
    """The port's ``steps`` steps in ``dtype`` on the data set's batches:
    (losses, parameters, statistics, parameters after the first step) in
    the reference's order."""
    rows = entry.train_rows(len(arrays["y"]), CONFIG)
    cast = {k: (v.astype(np.float64) if dtype == torch.float64 and k in ("x", "y") else v)
            for k, v in arrays.items()}
    ds = PatchDataset.from_arrays([{k: v[rows] for k, v in cast.items()}], device="cpu")
    model = entry.load_model(CONFIG, "cpu").to(dtype)
    state = ttrain.new_state(model, CONFIG["learning_rate"], CONFIG["dropout_seed"], "cpu")
    keys = list(p2n_normals.draw_variables(CONFIG, CONFIG["weights_seed"]))

    def flat(kind):
        return torch.cat([entry.flax_view(model, k).reshape(-1) for k in keys
                          if k.startswith(kind)]).clone()

    losses, first = [], None
    for batch in islice(ds.batches(CONFIG["batch"], seed=CONFIG["batch_seed"]), steps):
        losses.append(ttrain.train_step(state, batch)[1]["custom_val_loss"])
        first = flat("params/") if first is None else first
    return torch.stack(losses), flat("params/"), flat("batch_stats/"), first


def _ref(data, steps, dtype):
    cast = {k: (v.to(dtype) if k in ("x", "y") else v) for k, v in data.items()}
    variables = p2n_normals.draw_variables(CONFIG, CONFIG["weights_seed"])
    return ref.train(cast, variables, CONFIG, steps)


def _errors(got, want):
    return {"loss": float(((got[0] - want[0]).abs() / want[0].abs()).max()),
            "params": float((got[1] - want[1]).abs().max()),
            "stats": float(((got[2] - want[2]).abs() / want[2].abs().clamp(min=1.0)).max())}


def _within(err):
    return (err["loss"] <= LOSS_RTOL_64 and err["params"] <= PARAM_TOL_64
            and err["stats"] <= STATS_TOL_64)


def test_the_data_sets_are_equal_and_every_mask_takes_part(data):
    arrays, want = data
    for key, rkey in (("x", "x"), ("node_mask", "member"), ("nbr_mask", "g_mask"), ("y", "y"),
                      ("nbr_idx", "g_idx")):
        assert np.array_equal(arrays[key].astype(want[rkey].numpy().dtype), want[rkey].numpy())
    rows = ref.batch_rows(POINTS, CONFIG, STEPS).reshape(-1)
    node = arrays["node_mask"][rows]
    edges = (arrays["nbr_mask"][rows] & node[:, :, None]).sum(axis=2)
    assert (node.sum(axis=1) < CONFIG["num_nodes"]).any()
    assert (node.sum(axis=1) == CONFIG["num_nodes"]).any()
    assert (edges[node] < CONFIG["patch_k"]).any() and (edges[node] == CONFIG["patch_k"]).any()


@pytest.mark.parametrize("steps", [1, STEPS])
def test_the_float64_steps_match_the_reference(data, steps):
    err = _errors(_port(data[0], steps, torch.float64), _ref(data[1], steps, torch.float64))
    assert _within(err), err


def test_a_redrawn_dropout_mask_fails(data, monkeypatch):
    def redrawn(model, batch, generator, group):
        return model.draw_keep_masks(batch, torch.Generator().manual_seed(12345))

    monkeypatch.setattr(ttrain, "draw_local_keep", redrawn)
    err = _errors(_port(data[0], 1, torch.float64), _ref(data[1], 1, torch.float64))
    assert err["loss"] > 1e3 * LOSS_RTOL_64, err


def test_statistics_over_every_node_fail(data, monkeypatch):
    """BatchNorm whose statistics count the padded nodes as well."""
    plain = tedge.MaskedBatchNorm.forward

    def unmasked(self, x, mask, group=None):
        return plain(self, x, torch.ones_like(mask), group)

    monkeypatch.setattr(tedge.MaskedBatchNorm, "forward", unmasked)
    err = _errors(_port(data[0], 1, torch.float64), _ref(data[1], 1, torch.float64))
    assert err["loss"] > 1e3 * LOSS_RTOL_64 and err["stats"] > 1e3 * STATS_TOL_64, err


def test_a_mean_over_every_edge_fails(data, monkeypatch):
    """The EdgeConv's mean taken over all K edges, the masked ones too."""
    plain = tedge.EdgeConv.forward

    def unmasked(self, x, nbr_idx, nbr_mask, node_mask, group=None):
        return plain(self, x, nbr_idx, torch.ones_like(nbr_mask), node_mask, group)

    monkeypatch.setattr(tedge.EdgeConv, "forward", unmasked)
    err = _errors(_port(data[0], 1, torch.float64), _ref(data[1], 1, torch.float64))
    assert err["loss"] > 1e3 * LOSS_RTOL_64, err


def test_the_float32_first_loss_and_update_match_the_reference(data):
    got = _port(data[0], STEPS, torch.float32)
    want = _ref(data[1], STEPS, torch.float32)
    variables = p2n_normals.draw_variables(CONFIG, CONFIG["weights_seed"])
    numbers = entry.compare(got, {"start": entry.start_state(variables, "cpu"),
                                  "runs": [want, want]})
    assert numbers["loss0_rel"] <= LOSS0_RTOL_32, numbers
    assert numbers["first_update_rel"] <= FIRST_UPDATE_32, numbers


def test_the_float32_control_fails_the_first_update(data):
    """The reference at TF32 in the program's place."""
    variables = p2n_normals.draw_variables(CONFIG, CONFIG["weights_seed"])
    want = _ref(data[1], 1, torch.float32)
    control = ref.train(data[1], variables, CONFIG, 1, tf32=True)
    numbers = entry.compare(control, {"start": entry.start_state(variables, "cpu"),
                                      "runs": [want, want]})
    assert numbers["first_update_rel"] > 10 * FIRST_UPDATE_32, numbers


def test_a_data_set_from_arrays_is_the_data_set_of_the_same_arrays_saved(tmp_path, data):
    arrays = data[0]
    half = len(arrays["y"]) // 2
    parts = [{k: v[s] for k, v in arrays.items()} for s in (slice(0, half), slice(half, None))]
    shards = []
    for i, part in enumerate(parts):
        np.savez(tmp_path / f"s{i}.npz", **part)
        shards.append({"file": f"s{i}.npz", "count": len(part["y"])})
    manifest = {"shards": shards, "perm": [1, 0], "train": [1, 0], "val": [], "test": []}
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    read = PatchDataset(tmp_path, "train", device="cpu")
    mem = PatchDataset.from_arrays([parts[1], parts[0]], device="cpu")
    assert len(read) == len(mem) == len(arrays["y"])
    assert all(np.array_equal(read.data[k], mem.data[k]) for k in KEYS)
    for a, b in zip(read.batches(8, seed=3), mem.batches(8, seed=3), strict=True):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        assert a["nbr_idx"].dtype == torch.int64


def test_the_batch_span_records_once_a_batch_and_the_cpu_step_takes_no_graph(data):
    ds = PatchDataset.from_arrays([data[0]], device="cpu")
    before = dict(ttrain.GRAPHS)
    model = entry.load_model(CONFIG, "cpu")
    state = ttrain.new_state(model, CONFIG["learning_rate"], 0, "cpu")
    with prof.span("unrecorded"):  # the next recorded span starts afresh
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        for batch in islice(ds.batches(CONFIG["batch"], seed=1), 3):
            ttrain.train_step(state, batch)
    spans = prof.recorded()["spans"]
    assert spans["ngpd.train.batch"]["count"] == 3 and spans["ngpd.train"]["count"] == 3
    assert ttrain.GRAPHS == before
