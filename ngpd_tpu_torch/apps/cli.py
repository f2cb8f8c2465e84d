"""Command-line interface of the port (the ``denoise`` and ``eval``
subcommands of ``ngpd_tpu/apps/cli.py``):

  python -m ngpd_tpu_torch.apps.cli denoise noisy.obj -o out.obj
  python -m ngpd_tpu_torch.apps.cli denoise noisy.obj --gt clean.obj --until-min
  python -m ngpd_tpu_torch.apps.cli eval clean.obj out.obj

``denoise`` takes the reference's routes: normals are estimated (PVT over
12 neighbours, oriented) when the cloud has none; ``--until-min`` iterates
against ``--gt`` until the error stops falling; otherwise ``--fused`` or a
cloud of 100k points or more goes to the hybrid engine on the card and to
the windowed ``fused_denoise`` on the CPU, as the reference picks its
Pallas engine on its accelerator and ``fused_denoise`` elsewhere, and a
smaller cloud to the dense ``(N, k)`` pipeline. ``--device`` defaults to
``cuda``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

HYBRID_MIN_POINTS = 100_000


def _load_cloud(path):
    from ..io.obj import load_obj
    from ..io.ply import load_ply
    from ..io.xyz import load_xyz

    suffix = Path(path).suffix
    if suffix == ".obj":
        return load_obj(path)
    if suffix in (".xyz", ".clean_xyz"):
        return load_xyz(path)
    if suffix == ".ply":
        return load_ply(path)
    raise SystemExit(f"unsupported input format: {suffix}")


def _estimated_normals(points, k=12):
    from ..core.normals import orient_normals, pvt_normals
    from ..ops.knn import knn

    nbh, _ = knn(points, k, exclude_self=True)
    return orient_normals(points, pvt_normals(points, nbh), nbh)


def cmd_denoise(args):
    from ..config import DenoiseConfig
    from ..core.cuda_fused import denoise_hybrid
    from ..core.fused import fused_denoise
    from ..core.pipeline import denoise, denoise_until_minimum_error
    from ..device import resolve_device
    from ..io.obj import save_obj

    dev = resolve_device(args.device)
    cloud = _load_cloud(args.input)
    pts = cloud.points.to(dev)
    nrm = cloud.normals.to(dev) if cloud.has_normals() else _estimated_normals(pts)
    cfg = DenoiseConfig(feature_k=args.feature_k, step_k=args.step_k)
    strategy = tuple(args.strategy.split(","))
    if args.until_min:
        if not args.gt:
            raise SystemExit("--until-min requires --gt")
        gt = _load_cloud(args.gt).points
        out, nrm_out, err, iters = denoise_until_minimum_error(
            pts, nrm, gt, cfg, strategy=strategy,
            max_iterations=args.iterations or 64, device=dev,
        )
        print(f"stopped after {int(iters)} iterations, error {float(err):.4e}")
    elif (args.fused or len(cloud) >= HYBRID_MIN_POINTS) and dev.type == "cuda":
        out, nrm_out, _ = denoise_hybrid(
            pts, nrm, cfg, strategy=strategy,
            iterations=args.iterations or 2, window=args.window,
            lagged_nvt1=args.lagged_nvt1, device=dev,
        )
    elif args.fused or len(cloud) >= HYBRID_MIN_POINTS:
        out, nrm_out, _ = fused_denoise(
            pts, nrm, cfg, strategy=strategy,
            iterations=args.iterations or 2, window=args.window, device=dev,
        )
    else:
        out, nrm_out, _ = denoise(
            pts, nrm, cfg, strategy=strategy, iterations=args.iterations or 2,
            device=dev,
        )
    save_obj(args.output, out.cpu().numpy(), nrm_out.cpu().numpy())
    print(f"wrote {args.output}")


def cmd_eval(args):
    from ..device import resolve_device
    from ..ops import metrics

    dev = resolve_device(args.device)
    gt = _load_cloud(args.gt).points.to(dev)
    test = _load_cloud(args.input).points.to(dev)
    out = {
        "cd": float(torch.mean(metrics.chamfer_distance(test, gt))),
        "scd": float(torch.mean(metrics.single_chamfer_distance(test, gt))),
        "hausdorff_max": float(torch.max(metrics.hausdorff_distance(test, gt))),
        "paper": float(torch.mean(metrics.paper_distance(gt, test))),
    }
    print(json.dumps(out, indent=1))


def main(argv=None):
    p = argparse.ArgumentParser(prog="ngpd_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("denoise", help="classical point-cloud denoise")
    d.add_argument("input")
    d.add_argument("-o", "--output", required=True)
    d.add_argument("--iterations", type=int, default=None)
    d.add_argument("--feature-k", type=int, default=16)
    d.add_argument("--step-k", type=int, default=8)
    d.add_argument("--strategy", default="flat,edge,feature")
    d.add_argument("--until-min", action="store_true")
    d.add_argument("--gt", default=None)
    d.add_argument("--fused", action="store_true")
    d.add_argument("--window", type=int, default=512)
    d.add_argument("--lagged-nvt1", action="store_true",
                   help="reuse K2's filtered-NVT rows as the next "
                        "iteration's NVT1 (weight masks one half-step stale)")
    d.add_argument("--device", default="cuda")
    d.set_defaults(fn=cmd_denoise)

    e = sub.add_parser("eval", help="CD/sCD/Hausdorff/Paper metrics")
    e.add_argument("gt")
    e.add_argument("input")
    e.add_argument("--device", default="cuda")
    e.set_defaults(fn=cmd_eval)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
