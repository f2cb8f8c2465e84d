"""Throughput of the hybrid denoise on the card, with the CD quality gate.

The workload of the repo's ``bench.py``: a piecewise-planar "CAD roof"
cloud (``make_cloud``, a copy of ``bench.make_cloud``), ``feature_k=32``,
``step_k=8``, 20 iterations, ``tile=256``, ``window=128`` and
``lagged_nvt1`` on. ``run`` returns the fields of its JSON point line:
point-iterations per second over the best of 3 timed runs after a
warm-up, the kernel launches of the last timed run, and the Chamfer
ratio of denoised to noisy on a 20k subsample, gated at ``GATE_RATIO``.

  python -m ngpd_tpu_torch.bench [--n 1000000] [--iters 20] [--k 32]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

GATE_RATIO = 0.25


def make_cloud(n: int, seed: int = 0):
    """A piecewise-planar "CAD roof" surface: triangle waves in x and y
    give planar facets meeting in sharp creases, at a constant point
    spacing of 0.01. Returns (noisy, normals, clean) float32 arrays;
    normals are the analytic facet normals."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n))
    xs = np.linspace(0.0, 10.0 * side / 1000.0, side, dtype=np.float32)
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    p, amp = 2.5, 0.5

    def tri(t):
        return 2 * np.abs(t / p - np.floor(t / p + 0.5))

    def dtri(t):
        return np.sign(((t / p + 0.5) % 1.0) - 0.5) * 2 / p

    zz = amp * (tri(xx) + tri(yy))
    pts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.float32)
    gx = amp * dtri(xx).ravel()
    gy = amp * dtri(yy).ravel()
    extra = n - len(pts)
    if extra > 0:
        sel = rng.integers(0, len(pts), extra)
        pts = np.concatenate([pts, pts[sel]])
        gx = np.concatenate([gx, gx[sel]])
        gy = np.concatenate([gy, gy[sel]])
    normals = np.stack([-gx, -gy, np.ones_like(gx)], axis=-1)
    normals = (
        normals / np.linalg.norm(normals, axis=1, keepdims=True)
    ).astype(np.float32)
    noise = rng.normal(scale=0.02, size=(len(pts), 1)).astype(np.float32)
    clean = pts
    return (pts + normals * noise).astype(np.float32), normals, clean


def make_corner_cloud(n: int, side: int = 8, seed: int = 0):
    """Cube corners on a 3-D grid: three square faces of ``side`` points a
    side, spacing 0.01, meeting at a vertex, each corner 3 spacings clear
    of the next; positions jittered by 0.002. Unlike the roof, every class
    of the classifier is common here: at side 8 and 65,536 points the
    four-pass engine's first iteration calls about 80% of the points
    flat, 19% edge and 1% (over 500) corner (feature_k 32). Returns
    (noisy, normals, clean) float32 arrays."""
    rng = np.random.default_rng(seed)
    s = 0.01
    a, b = [x.ravel() for x in np.meshgrid(np.arange(side) * s, np.arange(side) * s,
                                           indexing="ij")]
    z = np.zeros_like(a)
    faces = [((a, b, z), (0.0, 0.0, 1.0)), ((z, a, b), (1.0, 0.0, 0.0)),
             ((a, z, b), (0.0, 1.0, 0.0))]
    pts = np.concatenate([np.stack(p, axis=1) for p, _ in faces])
    nrm = np.concatenate([np.tile(nv, (len(a), 1)) for _, nv in faces])
    pts, idx = np.unique(pts.round(6), axis=0, return_index=True)  # shared edges once
    nrm = nrm[idx]
    count = -(-n // len(pts))
    g = int(np.ceil(count ** (1.0 / 3.0)))
    grid = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"), axis=-1)
    offsets = grid.reshape(-1, 3)[:count] * (side + 3) * s
    clean = (pts[None] + offsets[:, None]).reshape(-1, 3)[:n].astype(np.float32)
    normals = np.tile(nrm, (count, 1))[:n].astype(np.float32)
    noisy = clean + rng.normal(scale=0.002, size=clean.shape).astype(np.float32)
    return noisy, normals, clean


def cd_ratio(out: np.ndarray, noisy: np.ndarray, clean: np.ndarray, device,
             subsample: int = 20_000):
    """(ratio, cd_noisy, cd_denoised) on a seeded subsample."""
    from .ops import metrics

    n = len(clean)
    q = min(n, subsample)
    sel = np.random.default_rng(1).choice(n, size=q, replace=False)

    def cd(x):
        c = torch.as_tensor(clean[sel], device=device)
        return float(torch.mean(metrics.chamfer_distance(
            c, torch.as_tensor(x[sel], device=device))))

    cd_noisy, cd_out = cd(noisy), cd(out)
    return cd_out / max(cd_noisy, 1e-30), cd_noisy, cd_out


def run(n: int = 1_000_000, iters: int = 20, k: int = 32, device=None,
        lagged_nvt1: bool = True, repeats: int = 3) -> dict:
    """Time the hybrid denoise and score it; returns the bench fields."""
    from .config import DenoiseConfig
    from .core.cuda_fused import denoise_hybrid
    from .device import resolve_device
    from .kernels import window as kw

    dev = resolve_device(device)
    noisy, nrm, clean = make_cloud(n)
    pts_t = torch.as_tensor(noisy, device=dev)
    nrm_t = torch.as_tensor(nrm, device=dev)
    cfg = DenoiseConfig(feature_k=k, step_k=8)

    def once():
        out = denoise_hybrid(pts_t, nrm_t, cfg, iterations=iters, tile=256,
                             window=128, lagged_nvt1=lagged_nvt1, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    once()  # warm-up: kernel build and load, allocator
    best = float("inf")
    for _ in range(repeats):
        kw.reset_launch_counts()
        t0 = time.perf_counter()
        out, _, _ = once()
        best = min(best, time.perf_counter() - t0)
        launches = dict(kw.LAUNCHES)
    ratio, cd_noisy, cd_out = cd_ratio(out.cpu().numpy(), noisy, clean, dev)
    value = n * iters / best
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {
        "metric": f"denoise throughput ({n} pts, k={k}, {iters} iters, {name})",
        "value": value,
        "unit": "point-iterations/s",
        "seconds": best,
        "lagged_nvt1": lagged_nvt1,
        "launches": launches,
        "quality_gate": "pass" if ratio <= GATE_RATIO else "fail",
        "quality_cd_ratio": ratio,
        "quality_cd_noisy": cd_noisy,
        "quality_cd_denoised": cd_out,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ngpd_tpu_torch.bench")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fresh-nvt1", action="store_true",
                    help="run K1 every iteration (lagged_nvt1 off)")
    args = ap.parse_args(argv)
    line = run(args.n, args.iters, args.k, args.device,
               lagged_nvt1=not args.fresh_nvt1)
    print(json.dumps(line))
    if line["quality_gate"] == "fail":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
