"""Rank bodies of the port's ``torch.distributed`` tests, and the harness that
spawns them.

``run_ranks(body, world, tmp, inputs)`` starts ``world`` gloo ranks
(``torch.multiprocessing``, start method ``spawn``, a ``FileStore`` in
``tmp``, one thread a rank); each runs the function named ``body`` of this
module on the numpy ``inputs`` and returns a dict of numpy results, which
the harness hands back per rank. Inputs and results travel through files:
arguments of a spawned process go down a pipe that the child reads only
after its imports, so large ones would start the ranks one by one.

A spawned child imports this module to find its body, so the module
imports no JAX: the test files, which do, compute the reference's side in
the pytest process.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_SECONDS = 300


def run_ranks(body: str, world: int, tmp, inputs: dict) -> list[dict]:
    """Each rank's result of ``body(rank, world, inputs)``; raises the first
    failing rank's error, or TimeoutError when the group has not finished
    within JOIN_SECONDS."""
    tmp = os.fspath(tmp)
    store = os.path.join(tmp, f"store_{body}_{world}")
    with open(_result_path(tmp, body, world, "inputs"), "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.start_processes(_entry, args=(body, world, store, tmp), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_SECONDS
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{body} on {world} ranks did not finish in {JOIN_SECONDS} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    results = []
    for rank in range(world):
        with open(_result_path(tmp, body, world, rank), "rb") as f:
            results.append(pickle.load(f))
    return results


def _result_path(tmp, body, world, rank):
    return os.path.join(tmp, f"{body}_{world}_rank{rank}.pkl")


def _entry(rank: int, body: str, world: int, store: str, tmp: str) -> None:
    torch.set_num_threads(1)
    from ngpd_tpu_torch.parallel.mesh import init_group

    with open(_result_path(tmp, body, world, "inputs"), "rb") as f:
        inputs = pickle.load(f)

    init_group(store, rank, world, device="cpu")
    try:
        result = globals()[body](rank, world, inputs)
    finally:
        dist.destroy_process_group()
    with open(_result_path(tmp, body, world, rank), "wb") as f:
        pickle.dump(result, f)


def _np(x):
    return x.detach().cpu().numpy()


def rows_of(results: list[dict], key: str, n: int):
    """The ranks' rows of an output concatenated in rank order, cut to n;
    a tuple output gives a tuple."""
    first = results[0][key]
    if isinstance(first, tuple):
        return tuple(np.concatenate([r[key][i] for r in results])[:n] for i in range(len(first)))
    return np.concatenate([r[key] for r in results])[:n]


def flip_bound(pos, cls, want_pos, want_cls):
    """The port's windowed engine against the reference's jitted one:
    tests/test_torch_fused.py's mask-flip bound on positions (classes equal
    on at least 99% of rows, at least 99.9% of the other rows within 2e-3,
    every row within 2e-2)."""
    diff = np.abs(pos - want_pos).max(axis=1)
    same = cls == want_cls
    print(f"classes equal {same.mean():.4f}, rows above 2e-4 {int((diff > 2e-4).sum())}, "
          f"max position difference {diff.max():.3g}")
    assert same.mean() > 0.99
    assert np.mean(diff[same] <= 2e-3) >= 0.999 and diff.max() <= 2e-2


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------


def parallel_cases(rank: int, world: int, inp: dict) -> dict:
    from ngpd_tpu_torch.collectives import COLLECTIVES, reset_counts
    from ngpd_tpu_torch.parallel import (chamfer_distance_sharded, denoise_sharded,
                                         fused_denoise_sharded, knn_sharded, make_mesh,
                                         shard_points)

    mesh = make_mesh(device="cpu")
    out = {}
    sp, _ = shard_points(inp["knn"], mesh, device="cpu")
    nbh, d = knn_sharded(sp, 8, mesh, device="cpu")
    out["knn"] = (_np(d), _np(nbh.idx), _np(nbh.mask))
    sp, _ = shard_points(inp["knn_self"], mesh, device="cpu")
    nbh, d = knn_sharded(sp, 6, mesh, exclude_self=True, device="cpu")
    out["knn_self"] = (_np(d), _np(nbh.idx), _np(nbh.mask))

    sa, _ = shard_points(inp["cd_a"], mesh, device="cpu")
    sb, _ = shard_points(inp["cd_b"], mesh, device="cpu")
    out["chamfer"] = float(chamfer_distance_sharded(sa, sb, mesh, device="cpu"))

    sp, _ = shard_points(inp["dn_pts"], mesh, device="cpu")
    sn, _ = shard_points(inp["dn_nrm"], mesh, pad_value=0.0, device="cpu")
    pos, nrm = denoise_sharded(sp, sn, mesh, iterations=2, device="cpu")
    out["denoise"] = (_np(pos), _np(nrm))

    sp, n = shard_points(inp["fu_pts"], mesh, device="cpu")
    sn, _ = shard_points(inp["fu_nrm"], mesh, pad_value=0.0, device="cpu")
    reset_counts()
    pos, nrm, cls = fused_denoise_sharded(sp, sn, mesh, iterations=2, tile=128, window=128,
                                          num_valid=n, device="cpu")
    out["fused_counts"] = dict(COLLECTIVES)
    out["fused"] = (_np(pos), _np(nrm), _np(cls))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_halo.py
# ---------------------------------------------------------------------------


def halo_cases(rank: int, world: int, inp: dict) -> dict:
    from ngpd_tpu_torch.collectives import COLLECTIVES, reset_counts
    from ngpd_tpu_torch.parallel import fused_denoise_sharded, make_mesh, shard_points
    from ngpd_tpu_torch.parallel.halo import fused_denoise_halo, morton_sort_sharded

    mesh = make_mesh(device="cpu")
    out = {}
    sp, n = shard_points(inp["sort_pts"], mesh, device="cpu")
    sn, _ = shard_points(inp["sort_nrm"], mesh, pad_value=0.0, device="cpu")
    sc = morton_sort_sharded(sp, sn, mesh, num_valid=n, device="cpu")
    out["sort"] = (_np(sc.pos), _np(sc.nrm), _np(sc.orig_idx))

    sp, n = shard_points(inp["pts"], mesh, device="cpu")
    sn, _ = shard_points(inp["nrm"], mesh, pad_value=0.0, device="cpu")
    kw = dict(iterations=2, tile=128, window=128, num_valid=n, device="cpu")
    reset_counts()
    out["halo"] = tuple(_np(x) for x in fused_denoise_halo(sp, sn, mesh, **kw))
    out["halo_counts"] = dict(COLLECTIVES)
    reset_counts()
    out["sharded"] = tuple(_np(x) for x in fused_denoise_sharded(sp, sn, mesh, **kw))
    out["sharded_counts"] = dict(COLLECTIVES)
    try:
        fused_denoise_halo(sp, sn, mesh, **{**kw, "window": 4096})
        out["wide_window"] = "ran"
    except ValueError as err:
        out["wide_window"] = str(err)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_dp_train.py
# ---------------------------------------------------------------------------


def _model(kind: str, spec: dict, dtype=torch.float32):
    from ngpd_tpu_torch.config import ModelConfig
    from ngpd_tpu_torch.models.dgcnn import DGCNN
    from ngpd_tpu_torch.models.patch2normal import Patch2NormalModel

    model = (Patch2NormalModel(ModelConfig(**spec["cfg"])) if kind == "patch2normal"
             else DGCNN(emb_dims=spec["emb_dims"]))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in spec["state"].items()}, strict=True)
    return model.to(dtype)


def step_gradients(kind: str, spec: dict, batch: dict, group, *, train: bool = True,
                   stats_group="group", dtype=torch.float64, seed: int = 0) -> dict:
    """One step's global loss, mean gradient and (train mode) new BatchNorm
    statistics, on this rank's rows of ``batch`` (all of it without a
    group). Train mode draws the keep masks from a generator seeded with
    ``seed``, as every rank's shared generator does. ``stats_group=None``
    is the stand-in whose BatchNorm takes per-rank statistics."""
    from ngpd_tpu_torch.collectives import all_reduce
    from ngpd_tpu_torch.learn import losses
    from ngpd_tpu_torch.learn.train import average_gradients, draw_local_keep, local_rows

    model = _model(kind, spec, dtype).train(train)
    rows = local_rows({k: torch.as_tensor(v) for k, v in batch.items()}, group)
    rows = {k: v.to(dtype) if v.is_floating_point() else v for k, v in rows.items()}
    bn_group = group if stats_group == "group" else None
    keep = (draw_local_keep(model, rows["y"].shape[0], torch.Generator().manual_seed(seed),
                            group) if train else None)
    if kind == "patch2normal":
        out = model(rows["x"], rows["nbr_idx"], rows["nbr_mask"], rows["node_mask"], keep=keep,
                    group=bn_group)
        loss = losses.custom_val_loss(out, rows["y"])
    else:
        out = model(rows["x"], keep=keep, group=bn_group)
        loss = torch.mean((out - rows["y"]) ** 2)
    loss.backward()
    if group is not None:
        average_gradients(model, group)
        loss = all_reduce(loss.detach(), "sum", group) / dist.get_world_size(group)
    return {"loss": float(loss.detach()),
            "grads": {k: _np(p.grad) for k, p in model.named_parameters()},
            "stats": {k: _np(b) for k, b in model.named_buffers() if "running" in k}}


def dp_cases(rank: int, world: int, inp: dict) -> dict:
    from ngpd_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axis_names=("dp",), device="cpu")
    group = mesh.get_group("dp")
    out = {"p2n_eval": step_gradients("patch2normal", inp["p2n_ref"], inp["p2n_ref_batch"],
                                      group, train=False, dtype=torch.float32)}
    for kind in ("patch2normal", "dgcnn"):
        spec, batch = inp[kind], inp[f"{kind}_batch"]
        out[kind] = step_gradients(kind, spec, batch, group)
        out[f"{kind}_per_rank_stats"] = step_gradients(kind, spec, batch, group,
                                                       stats_group=None)
    out.update(_fit_cases(rank, mesh, inp))
    pmesh = make_mesh(device="cpu")
    for name in ("ico", "noisy"):
        out[f"faces_{name}"] = _np(pmesh_normals(inp[name], pmesh))
    return out


def _fit_cases(rank: int, mesh, inp: dict) -> dict:
    """One epoch of ``fit(mesh=)`` and of ``fit_dgcnn(mesh=)``: the final
    parameters of each rank, and what the lead rank wrote."""
    from ngpd_tpu_torch.config import TrainConfig
    from ngpd_tpu_torch.learn import train, train_dgcnn

    tmp = inp["tmp"]
    batches = [{k: torch.as_tensor(v) for k, v in b.items()} for b in inp["fit_batches"]]
    model = _model("patch2normal", inp["patch2normal"])
    state = train.new_state(model, 1e-3, 0, "cpu")
    train.fit(state, lambda: iter(batches[:2]), lambda: iter(batches[2:]),
              TrainConfig(num_epochs=1, min_epochs=1, batch_size=16),
              log_dir=os.path.join(tmp, f"logs_rank{rank}"), mesh=mesh)
    store = train_dgcnn.ShardStore([inp["shard"]], seed=0, device="cpu")
    _, dstate = train_dgcnn.init_dgcnn(seed=0, emb_dims=inp["dgcnn"]["emb_dims"], device="cpu")
    dstate = train_dgcnn.fit_dgcnn(dstate, store, batch_size=16, num_epochs=1,
                                   log_dir=os.path.join(tmp, f"dlogs_rank{rank}"), mesh=mesh)
    try:
        train_dgcnn.fit_dgcnn(dstate, store, batch_size=16, num_epochs=1, scan_steps=2,
                              log_dir=os.path.join(tmp, "unused"), mesh=mesh)
        refused = ""
    except ValueError as err:
        refused = str(err)
    return {"fit_params": {k: _np(p) for k, p in state.model.named_parameters()},
            "fit_steps": state.step,
            "fit_logged": os.path.exists(os.path.join(tmp, f"logs_rank{rank}", "metrics.jsonl")),
            "fit_dgcnn_params": {k: _np(p) for k, p in dstate.model.named_parameters()},
            "fit_dgcnn_logged": os.path.exists(os.path.join(tmp, f"dlogs_rank{rank}",
                                                            "metrics.jsonl")),
            "scan_refused": refused}


def pmesh_normals(case: dict, pmesh):
    """``predict_face_normals`` of ``case``'s mesh and DGCNN weights, the
    patch inference split over ``pmesh`` (over nothing without one)."""
    from ngpd_tpu_torch.config import PatchConfig
    from ngpd_tpu_torch.meshproc.gcn_denoiser import predict_face_normals
    from ngpd_tpu_torch.meshproc.trimesh import TriMesh

    mesh = TriMesh.from_numpy(case["v"], case["f"])
    return predict_face_normals(mesh, _model("dgcnn", case["model"]).eval(),
                                PatchConfig(num_nodes=case["num_nodes"]), device="cpu",
                                pmesh=pmesh)
