"""Where the time goes in one hybrid-denoise run on the card.

    python -m ngpd_tpu_torch.profile_hybrid [--n 1000000] [--iters 20] [--k 32]
                                            [--passes | --lagged | --mesh | --point
                                             | --train | --dense]

Runs the bench workload (``bench.make_cloud``, lagged_nvt1) once to warm
up, then once under ``torch.profiler`` with CPU and CUDA activities, and
prints one JSON line: the run's wall time (host clock, ending in a
synchronize), the device's busy time (union of kernel intervals) and idle
share, device time and kernel count by group (K0, K1, K2, the two stage
kernels HYBRID_VU and HYBRID_UPDATE, and every other kernel: the
prologue's and the lag state's torch ops, Morton sort and unsort), the
ten kernels with the most device time, and the port's spans over the run
(``utils.prof.recorded()``: count, host ms, self host ms and stream ms by
name, e.g. ``ngpd.hybrid.vu_stage``; the entries without spans, the pass
engine and the learned track, record none). ``--passes`` profiles the
pass engine (``denoise_passes``, exact delta) on the same cloud instead,
grouped by pass A-D and torch (prologue, packs, delta state, sort);
``--lagged`` its lagged-delta mode (pass A, the fused pass BD, torch).
``--mesh`` profiles the two-pass mesh cascade of ``bench.run_mesh`` (plain
torch over the kNN, feature-kNN and edge-block kernels; 81,920 faces), grouped by
what torch's kernels do (matrix products, top-k and sorts, gathers and
scatters, reductions, the rest). ``--point`` profiles the learned point
track, ``predict_cloud_normals`` with the seeded full-width Patch2Normal on
``make_cloud(--n)`` (100,000 points unless given) with normals estimated,
grouped as ``--mesh`` is. ``--train`` profiles one training step of each
learned model at full width after a warm-up step, grouped as ``--mesh`` is
(gathers with their scatter-add backward under ``gather_scatter``): the
Patch2Normal at batch 64 on ``make_cloud(4096)``'s patches, then the DGCNN
(emb_dims 1024) at batch 256 on a noisy ``cad_suite`` box's patches; one
JSON line each. ``--dense`` profiles the dense (N, k) pipeline, the CLI's
route under 100k points: ``core/pipeline.py::denoise`` on
``make_cloud(--n)`` (32,768 points, 2 iterations, feature_k 16, step_k 8
unless given), grouped as ``--mesh`` is. In every torch-grouped profile the
kNN kernel (``knn_kernel``, ``knn_merge_kernel``) is a group of its own,
``knn``, and so are the feature kNN (``feature_knn``) and the edge block
(``edge_block``). Needs a card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


ENGINES = ("hybrid", "passes", "passes_lagged")  # the engines with kernels of the port


def _group(name: str) -> str:
    for k in ("k0", "k1", "k2", "hybrid_vu", "hybrid_update", "pass_a", "pass_bd", "pass_b",
              "pass_c", "pass_d"):
        if f"{k}_kernel" in name:
            return k.upper()
    return "torch"


# Kernel-name fragments of torch's CUDA kernels, first match wins.
_MESH_GROUPS = (("feature_knn", ("feature_knn_kernel",)),
                ("edge_block", ("edge_block_kernel",)),
                ("knn", ("knn_kernel", "knn_merge_kernel")),
                ("matmul", ("gemm", "cutlass", "cublas", "xmma")),
                ("topk_sort", ("topk", "sort", "radix", "bitonic")),
                ("gather_scatter", ("index", "gather", "scatter")),
                ("reduce", ("reduce",)))


def _mesh_group(name: str) -> str:
    low = name.lower()
    for group, keys in _MESH_GROUPS:
        if any(key in low for key in keys):
            return group
    return "elementwise_other"


def _train_step(engine: str, dev):
    """One full-width training step of a learned model, as a closure over
    its state and batch, and the batch size."""
    from .bench import make_cloud
    from .core.noise import draw_noise
    from .core.patches import extract_patches
    from .learn import train, train_dgcnn
    from .meshproc.patches import extract_mesh_patches
    from .meshproc.synthetic import box
    from .meshproc.trimesh import add_mesh_noise

    if engine == "train_point":
        noisy, nrm, _ = make_cloud(4096)
        b = extract_patches(torch.as_tensor(noisy), torch.as_tensor(nrm), device=dev)
        batch = {k: getattr(b, k)[:64] for k in ("x", "nbr_idx", "nbr_mask", "node_mask", "y")}
        _, state = train.init_model(device=dev)
        return lambda: train.train_step(state, batch), 64
    clean = box(n=10)
    noisy = add_mesh_noise(clean, draw_noise(clean.num_vertices,
                                             torch.Generator().manual_seed(0)), 0.3)
    b = extract_mesh_patches(noisy, gt_normals=clean.face_data()[0], device=dev)
    batch = {"x": b.inputs[:256], "y": b.y[:256]}
    _, state = train_dgcnn.init_dgcnn(device=dev)
    return lambda: train_dgcnn.dgcnn_train_step(state, batch), 256


def profile_run(n: int, iters: int, k: int, engine: str = "hybrid") -> dict:
    """``engine``: "hybrid", "passes" (exact delta), "passes_lagged",
    "mesh" (the bench's cascade; n, iters and k unused), "point"
    (``predict_cloud_normals`` on n points; iters and k unused) or "dense"
    (``denoise`` on n points, iters iterations, feature_k k, step_k 8)."""
    from torch.profiler import ProfilerActivity, profile

    from .bench import make_cloud, mesh_cascade, mesh_workload
    from .config import DenoiseConfig
    from .core.cuda_fused import denoise_hybrid, denoise_passes
    from .core.pipeline import denoise
    from .device import resolve_device
    from .learn.predict import predict_cloud_normals
    from .models.patch2normal import init_patch2normal
    from .utils.prof import recorded

    dev = resolve_device("cuda")
    if engine in ("train_point", "train_mesh"):
        step, n = _train_step(engine, dev)
    elif engine == "mesh":
        cascade = mesh_cascade(dev)
        mesh = mesh_workload()[1].to(dev)
        n = mesh.num_faces
    else:
        noisy, nrm, _ = make_cloud(n)
        pts = torch.as_tensor(noisy, device=dev)
        nr = torch.as_tensor(nrm, device=dev)
        cfg = DenoiseConfig(feature_k=k, step_k=8)

    model = init_patch2normal(seed=0).to(dev) if engine == "point" else None
    if engine in ("train_point", "train_mesh"):
        iters = k = None

    def once():
        if engine in ("train_point", "train_mesh"):
            step()
        elif engine == "mesh":
            cascade(mesh)
        elif engine == "point":
            predict_cloud_normals(model, pts, device=dev)
        elif engine == "dense":
            denoise(pts, nr, cfg, iterations=iters, device=dev)
        elif engine != "hybrid":
            denoise_passes(pts, nr, cfg, iterations=iters, device=dev,
                           delta_mode="lagged" if engine == "passes_lagged" else "exact")
        else:
            denoise_hybrid(pts, nr, cfg, iterations=iters, lagged_nvt1=True, device=dev)
        torch.cuda.synchronize(dev)

    once()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        once()
        wall = time.perf_counter() - t0

    spans, groups, per_name = [], {}, {}
    for e in prof.events():
        # A user annotation (the optimizer's step range) is no kernel.
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        g = groups.setdefault((_group if engine in ENGINES else _mesh_group)(e.name),
                              {"ms": 0.0, "kernels": 0})
        g["ms"] += (t - s) / 1e3
        g["kernels"] += 1
        per_name[e.name] = per_name.get(e.name, 0.0) + (t - s) / 1e3
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    spans.sort()
    busy, cur_s, cur_t = 0.0, *spans[0]
    for s, t in spans[1:]:
        if s > cur_t:
            busy += cur_t - cur_s
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy = (busy + cur_t - cur_s) / 1e6
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "engine": engine,
        "n": n, "iters": iters, "k": k, "device": torch.cuda.get_device_name(dev),
        "wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
        "groups": groups,
        "top_kernels_ms": [[name[:120], ms] for name, ms in top],
        "spans": recorded(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ngpd_tpu_torch.profile_hybrid")
    ap.add_argument("--n", type=int, default=None,
                    help="points (1,000,000; 100,000 with --point, 32,768 with --dense)")
    ap.add_argument("--iters", type=int, default=None, help="iterations (20; 2 with --dense)")
    ap.add_argument("--k", type=int, default=None, help="feature_k (32; 16 with --dense)")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--passes", action="store_const", dest="engine", const="passes",
                       help="profile the pass engine (exact delta) instead of the hybrid")
    which.add_argument("--lagged", action="store_const", dest="engine",
                       const="passes_lagged", help="profile the pass engine in lagged-delta mode")
    which.add_argument("--mesh", action="store_const", dest="engine", const="mesh",
                       help="profile the two-pass mesh cascade (bench.run_mesh's workload)")
    which.add_argument("--point", action="store_const", dest="engine", const="point",
                       help="profile predict_cloud_normals (the learned point track)")
    which.add_argument("--train", action="store_const", dest="engine", const="train",
                       help="profile one training step of Patch2Normal and of the DGCNN")
    which.add_argument("--dense", action="store_const", dest="engine", const="dense",
                       help="profile the dense (N, k) pipeline's denoise")
    args = ap.parse_args(argv)
    if args.engine == "train":
        for engine in ("train_point", "train_mesh"):
            print(json.dumps(profile_run(0, 0, 0, engine)), flush=True)
        return
    dense = args.engine == "dense"
    n = args.n or {"point": 100_000, "dense": 32_768}.get(args.engine, 1_000_000)
    iters = args.iters or (2 if dense else 20)
    k = args.k or (16 if dense else 32)
    print(json.dumps(profile_run(n, iters, k, args.engine or "hybrid")))


if __name__ == "__main__":
    main()
