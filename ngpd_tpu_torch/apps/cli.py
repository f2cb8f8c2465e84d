"""Command-line interface of the port (the ``denoise``, ``eval`` and
``denoise-mesh`` subcommands of ``ngpd_tpu/apps/cli.py``):

  python -m ngpd_tpu_torch.apps.cli denoise noisy.obj -o out.obj
  python -m ngpd_tpu_torch.apps.cli denoise noisy.obj --gt clean.obj --until-min
  python -m ngpd_tpu_torch.apps.cli eval clean.obj out.obj
  python -m ngpd_tpu_torch.apps.cli denoise-mesh noisy.obj -o out.obj \
      --ckpt assets/dgcnn_mesh.npz --ckpt2 assets/dgcnn_mesh_2.npz --gcns 2 [--gt clean.obj]

``denoise`` takes the reference's routes: normals are estimated (PVT over
12 neighbours, oriented) when the cloud has none; ``--until-min`` iterates
against ``--gt`` until the error stops falling; otherwise ``--fused`` or a
cloud of 100k points or more goes to the hybrid engine on the card and to
the windowed ``fused_denoise`` on the CPU, as the reference picks its
Pallas engine on its accelerator and ``fused_denoise`` elsewhere, and a
smaller cloud to the dense ``(N, k)`` pipeline. ``denoise-mesh`` runs the
GCN cascade with ``--ckpt`` (``.npz``, ``.t7`` or ``.pt`` weights) and the
guided filter alone without it, guided by the ``--gt`` normals or the
mesh's own. ``--device`` defaults to ``cuda``.
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


def cmd_denoise_mesh(args):
    from ..config import GNFConfig
    from ..device import resolve_device
    from ..io.obj import read_obj, save_obj
    from ..meshproc import metrics as mesh_metrics
    from ..meshproc.filtering import guided_normal_filter
    from ..meshproc.trimesh import TriMesh

    dev = resolve_device(args.device)
    data = read_obj(args.input)
    if data.fv.shape[0] == 0:
        raise SystemExit("denoise-mesh needs a triangle mesh input")
    mesh = TriMesh.from_numpy(data.v, data.fv, device=dev)
    cfg = GNFConfig(
        radius_scale=args.radius_scale,
        sigma_s_scale=args.sigma_s_scale,
        normal_iterations=args.normal_iterations,
        vertex_iterations=args.vertex_iterations,
        sigma_r=args.sigma_r,
        guidance_smooth_iterations=args.guidance_smooth,
        guidance_smooth_sigma=args.guidance_smooth_sigma,
    )
    gt_mesh = None
    if args.gt:
        gt_data = read_obj(args.gt)
        gt_mesh = TriMesh.from_numpy(gt_data.v, gt_data.fv, device=dev)
        print(f"Ea before: {float(mesh_metrics.mean_angular_error(mesh, gt_mesh)):.3f} deg")

    if args.ckpt:
        # The cascade: patch-network normals guide the filter, --gcns
        # passes with rebuilt neighbourhoods.
        from ..learn.weights import load_dgcnn_state_dict
        from ..meshproc.gcn_denoiser import gcn_denoise_mesh
        from ..models.dgcnn import dgcnn_from_state_dict

        model = dgcnn_from_state_dict(load_dgcnn_state_dict(args.ckpt))
        variables2 = load_dgcnn_state_dict(args.ckpt2) if args.ckpt2 else None
        passes = args.gcns
        cfg2 = None
        if args.pass2:
            ni2, sr2, vi2 = args.pass2.split(":")
            cfg2 = GNFConfig(
                radius_scale=args.radius_scale,
                sigma_s_scale=args.sigma_s_scale,
                normal_iterations=int(ni2),
                sigma_r=float(sr2),
                vertex_iterations=int(vi2),
            )
        if args.auto:
            # The regime from the input itself (meshproc.autorecipe);
            # overrides --gcns, --pass2 and the kernel flags.
            from ..meshproc.autorecipe import pick_recipe

            recipe = pick_recipe(mesh, device=dev)
            passes, cfg, cfg2 = recipe.passes, recipe.gnf_cfg, recipe.gnf_cfg2
            print(f"auto recipe: {recipe.label} "
                  f"(noise {recipe.stats.noise_deg:.1f} deg, "
                  f"crease density {recipe.stats.crease_density:.2f})")
        out = gcn_denoise_mesh(mesh, model, passes=passes, gnf_cfg=cfg,
                               batch_size=args.batch_size, variables2=variables2,
                               bucketed=args.bucketed, gnf_cfg2=cfg2, device=dev)
    else:
        # Guidance: the GT normals when given, else the mesh's own.
        guide = gt_mesh if gt_mesh is not None else mesh
        out = guided_normal_filter(mesh, guide.face_data()[0], cfg, device=dev)
        for _ in range(args.gcns - 1):
            guide = gt_mesh if gt_mesh is not None else out
            out = guided_normal_filter(out, guide.face_data()[0], cfg, device=dev)
    colors = None
    if gt_mesh is not None:
        print(f"Ea after: {float(mesh_metrics.mean_angular_error(out, gt_mesh)):.3f} deg")
        if args.error_map:
            colors = mesh_metrics.error_map_colors(out, gt_mesh)
    save_obj(args.output, out.v.cpu().numpy(), colors=colors, faces=out.f.cpu().numpy())
    print(f"wrote {args.output}")


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

    dm = sub.add_parser("denoise-mesh", help="GCN + guided normal filtering")
    dm.add_argument("input")
    dm.add_argument("-o", "--output", required=True)
    dm.add_argument("--gt", default=None)
    dm.add_argument("--ckpt", default=None,
                    help="DGCNN weights (.npz archive, or reference .t7/.pt)")
    dm.add_argument("--ckpt2", default=None,
                    help="second-stage weights for passes >= 2; defaults to --ckpt")
    dm.add_argument("--gcns", type=int, default=1,
                    help="number of GCN+GNF passes (the app's box_gcns knob)")
    dm.add_argument("--pass2", default=None, metavar="NI:SR:VI",
                    help="filter knobs for passes >= 2 (e.g. 4:0.12:2); defaults "
                         "to the pass-1 knobs")
    dm.add_argument("--auto", action="store_true",
                    help="estimate the noise/crease regime from the input and pick "
                         "passes + filter knobs (meshproc.autorecipe); overrides "
                         "--gcns/--pass2 and the kernel knobs")
    dm.add_argument("--bucketed", action="store_true",
                    help="pad the mesh to power-of-two shape buckets first "
                         "(the same mesh comes out)")
    dm.add_argument("--batch-size", type=int, default=720)
    dm.add_argument("--normal-iterations", type=int, default=20)
    dm.add_argument("--sigma-r", type=float, default=0.12,
                    help="guidance-range bandwidth")
    dm.add_argument("--vertex-iterations", type=int, default=8)
    dm.add_argument("--radius-scale", type=float, default=2.0,
                    help="face-neighbourhood radius multiple")
    dm.add_argument("--sigma-s-scale", type=float, default=1.0,
                    help="spatial bandwidth multiple of the mean centroid spacing")
    dm.add_argument("--guidance-smooth", type=int, default=0,
                    help="bilateral smoothing rounds of the guidance field")
    dm.add_argument("--guidance-smooth-sigma", type=float, default=0.5,
                    help="range bandwidth of --guidance-smooth")
    dm.add_argument("--error-map", action="store_true")
    dm.add_argument("--device", default="cuda")
    dm.set_defaults(fn=cmd_denoise_mesh)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
