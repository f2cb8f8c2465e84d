"""Command-line interface of the port (the ``denoise`` and ``eval``
subcommands of ``ngpd_tpu/apps/cli.py``):

  python -m ngpd_tpu_torch.apps.cli denoise noisy.obj -o out.obj --fused
  python -m ngpd_tpu_torch.apps.cli eval clean.obj out.obj

``denoise`` takes the hybrid engine on ``--fused`` or for clouds of
100k points or more, as the reference does. Its other routes (the dense
path, ``--until-min``, and clouds without normals, which need normal
estimation) are not ported yet and exit with a message. ``--device``
defaults to ``cuda``.
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


def _not_ported(what: str):
    raise SystemExit(
        f"{what} is not ported to ngpd_tpu_torch yet (see ROADMAP.md); "
        "use python -m ngpd_tpu.apps.cli for it"
    )


def cmd_denoise(args):
    from ..config import DenoiseConfig
    from ..core.cuda_fused import denoise_hybrid
    from ..io.obj import save_obj

    cloud = _load_cloud(args.input)
    if args.until_min:
        _not_ported("--until-min (denoise until minimum error)")
    if not cloud.has_normals():
        _not_ported("normal estimation for clouds without normals")
    if not (args.fused or len(cloud) >= HYBRID_MIN_POINTS):
        _not_ported(
            f"the dense denoise path (clouds under {HYBRID_MIN_POINTS} points "
            "without --fused)"
        )
    cfg = DenoiseConfig(feature_k=args.feature_k, step_k=args.step_k)
    out, nrm_out, _ = denoise_hybrid(
        cloud.points, cloud.normals, cfg,
        strategy=tuple(args.strategy.split(",")),
        iterations=args.iterations or 2, window=args.window,
        lagged_nvt1=args.lagged_nvt1, device=args.device,
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
