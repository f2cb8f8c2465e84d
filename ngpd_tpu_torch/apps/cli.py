"""Command-line interface of the port: the subcommands of
``ngpd_tpu/apps/cli.py``:

  python -m ngpd_tpu_torch.apps.cli denoise noisy.obj -o out.obj
  python -m ngpd_tpu_torch.apps.cli denoise noisy.obj --gt clean.obj --until-min
  python -m ngpd_tpu_torch.apps.cli eval clean.obj out.obj
  python -m ngpd_tpu_torch.apps.cli make-dataset raw/*.obj -o patchds/ [--sample-points N]
  python -m ngpd_tpu_torch.apps.cli train patchds/ -o run/ [--epochs 100 --batch-size 64]
  python -m ngpd_tpu_torch.apps.cli predict-normals noisy.obj -o n.xyz \
      [--ckpt weights.npz | --ckpt run/ckpts]
  python -m ngpd_tpu_torch.apps.cli add-noise clean.obj -o noisy.obj --level 0.3 \
      [--save-noise DIR | --load-noise FILE.npz]
  python -m ngpd_tpu_torch.apps.cli denoise-mesh noisy.obj -o out.obj \
      --ckpt assets/dgcnn_mesh.npz --ckpt2 assets/dgcnn_mesh_2.npz --gcns 2 \
      [--gt clean.obj [--error-map]] [--html view.html]

``denoise`` takes the reference's routes: normals are estimated (PVT over
12 neighbours, oriented) when the cloud has none; ``--until-min`` iterates
against ``--gt`` until the error stops falling; otherwise ``--fused`` or a
cloud of 100k points or more goes to the hybrid engine on the card and to
the windowed ``fused_denoise`` on the CPU, as the reference picks its
Pallas engine on its accelerator and ``fused_denoise`` elsewhere, and a
smaller cloud to the dense ``(N, k)`` pipeline. ``make-dataset`` writes
Patch2Normal's patch shards and manifest (``learn/dataset.py``, noise from
a generator seeded with ``TrainConfig.seed`` on the device); ``train``
fits a seeded Patch2Normal to them (``learn/train.py``), logs under
``-o``/logs and keeps the top-k checkpoints under ``-o``/ckpts.
``predict-normals`` runs the Patch2Normal model on one MD patch per point
(normals estimated first) with the weights of a flat ``.npz`` archive of
Flax variables (``save_variables_npz``) or of the best checkpoint of a
``train`` checkpoint directory, or a seeded initialisation without
``--ckpt``; it writes the points and the predicted normals as ``.xyz``. ``add-noise``
corrupts a mesh (an OBJ with faces) or a cloud, its draws from a
``torch.Generator`` seeded with ``--seed`` on the device (other numbers
than the reference's ``jax.random``), and can save the noisy positions or
re-apply saved ones. ``denoise-mesh`` runs the GCN cascade with ``--ckpt``
(``.npz``, ``.t7`` or ``.pt`` weights) and the guided filter alone without
it, guided by the ``--gt`` normals or the mesh's own; ``--html`` also
writes a standalone viewer. ``--device`` defaults to ``cuda``.
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
    from ..core.normals import estimated_normals

    return estimated_normals(points, k)


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
    if args.html:
        from .htmlviewer import export_html

        export_html(args.html, out.v.cpu().numpy(), faces=out.f.cpu().numpy(),
                    colors=colors, title=Path(args.output).name)
        print(f"wrote {args.html}")


def cmd_make_dataset(args):
    from ..config import TrainConfig
    from ..learn.dataset import generate_dataset

    manifest = generate_dataset(args.inputs, args.output, train_cfg=TrainConfig(),
                                sample_points=args.sample_points, balance=not args.no_balance,
                                device=args.device)
    total = sum(s["count"] for s in manifest["shards"])
    print(f"wrote {len(manifest['shards'])} shards, {total} patches")


def cmd_train(args):
    from ..config import ModelConfig, TrainConfig
    from ..learn.dataset import PatchDataset
    from ..learn.train import fit, init_model

    train_cfg = TrainConfig(num_epochs=args.epochs, batch_size=args.batch_size)
    _, state = init_model(ModelConfig(), train_cfg, device=args.device)
    train_ds = PatchDataset(args.dataset, "train", device=args.device)
    val_ds = PatchDataset(args.dataset, "val", device=args.device)
    print(f"train {len(train_ds)} patches, val {len(val_ds)}")
    fit(state,
        lambda: train_ds.batches(train_cfg.batch_size, seed=0),
        lambda: val_ds.batches(train_cfg.batch_size, seed=1),
        train_cfg,
        log_dir=Path(args.output) / "logs",
        checkpoint_dir=Path(args.output) / "ckpts")
    print(f"done; checkpoints under {args.output}/ckpts")


def _patch2normal(ckpt):
    """The model of ``--ckpt`` (a flat ``.npz`` of Flax variables, or a
    ``train`` checkpoint directory: its best step's), or the seeded
    initialisation without one."""
    from ..learn.checkpoints import CheckpointManager
    from ..learn.weights import load_dgcnn_npz, patch2normal_state_dict_from_variables
    from ..models.patch2normal import Patch2NormalModel, init_patch2normal

    if ckpt is None:
        return init_patch2normal(seed=0)
    if (Path(ckpt) / "scores.json").is_file():
        ckpt = CheckpointManager(ckpt).variables_path()
    if not str(ckpt).endswith(".npz"):
        raise SystemExit(
            f"--ckpt {ckpt}: the port reads a flat .npz archive of Flax variables or a "
            "checkpoint directory of its own train command; "
            "convert an orbax checkpoint with ngpd_tpu.learn.weights.save_variables_npz"
            "({'params': state.params, 'batch_stats': state.batch_stats})")
    model = Patch2NormalModel()
    model.load_state_dict(patch2normal_state_dict_from_variables(load_dgcnn_npz(ckpt)),
                          strict=True)
    return model.eval()


def cmd_predict_normals(args):
    from ..device import resolve_device
    from ..io.xyz import save_xyz
    from ..learn.predict import predict_cloud_normals

    dev = resolve_device(args.device)
    cloud = _load_cloud(args.input)
    model = _patch2normal(args.ckpt)
    normals = predict_cloud_normals(model, cloud.points, device=dev)
    save_xyz(args.output, cloud.valid_points(), normals.cpu().numpy())
    print(f"wrote {args.output}")


def _save_cloud(path, points, normals=None):
    suffix = str(path)
    if suffix.endswith(".ply"):
        from ..io.ply import save_ply

        save_ply(path, points, normals)
    elif suffix.endswith((".xyz", ".clean_xyz")):
        from ..io.xyz import save_xyz

        save_xyz(path, points, normals)
    else:
        from ..io.obj import save_obj

        save_obj(path, points, normals)


def cmd_add_noise(args):
    """Corrupt a mesh or a cloud (the app's noise buttons): stdev = level x
    the mean edge length, along the normals or in a random direction,
    Gaussian or impulsive; ``--save-noise`` keeps the noisy positions,
    ``--load-noise`` re-applies kept ones instead of drawing."""
    from ..core import noise as noise_mod
    from ..device import resolve_device
    from ..io.obj import read_obj, save_obj

    dev = resolve_device(args.device)
    noise_type = {"gaussian": noise_mod.GAUSSIAN, "impulse": noise_mod.IMPULSIVE}[args.type]
    direction = {"normal": noise_mod.ALONG_NORMAL,
                 "random": noise_mod.RANDOM_DIRECTION}[args.direction]
    faces = None
    if args.input.endswith(".obj"):
        data = read_obj(args.input)
        if data.fv is not None and data.fv.shape[0] > 0:
            faces = np.asarray(data.fv)
    if args.load_noise:
        noisy = noise_mod.load_noise(args.load_noise, device=dev).cpu().numpy()
        if faces is not None:
            save_obj(args.output, noisy, faces=faces)
        else:
            _save_cloud(args.output, noisy)
        print(f"wrote {args.output} (positions from {args.load_noise})")
        return

    gen = torch.Generator(dev).manual_seed(args.seed)
    if faces is not None:
        from ..meshproc.trimesh import TriMesh, add_mesh_noise

        mesh = TriMesh.from_numpy(data.v, faces, device=dev)
        draws = noise_mod.draw_noise(mesh.num_vertices, gen)
        noisy = add_mesh_noise(mesh, draws, args.level, noise_type=noise_type,
                               direction=direction).v
        save_obj(args.output, noisy.cpu().numpy(), faces=faces)
    else:
        from ..ops import metrics
        from ..ops.knn import knn

        cloud = _load_cloud(args.input)
        pts = cloud.points.to(dev)
        nrm = cloud.normals.to(dev) if cloud.has_normals() else _estimated_normals(pts)
        nbh, _ = knn(pts, 12, exclude_self=True)
        mel = metrics.average_edge_length(pts, nbh)
        gauss, perm = noise_mod.draw_noise(pts.shape[0], gen)
        noisy = noise_mod.apply_noise(pts, nrm, gauss, perm, args.level, mel,
                                      noise_type=noise_type, direction=direction)
        _save_cloud(args.output, noisy.cpu().numpy(), nrm.cpu().numpy())
    print(f"wrote {args.output}")
    if args.save_noise:
        name = noise_mod.save_noise(args.save_noise, noisy, args.level,
                                    noise_type=noise_type, direction=direction)
        print(f"saved noise realization {args.save_noise}/{name}")


def main(argv=None):
    # The build cache of the kernels and the native runtime first, as the
    # reference enables its compilation cache; done here, not at import
    # time, so merely importing this module mutates nothing.
    from ..utils.cache import enable_compilation_cache

    enable_compilation_cache()
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

    m = sub.add_parser("make-dataset", help="generate patch shards")
    m.add_argument("inputs", nargs="+")
    m.add_argument("-o", "--output", required=True)
    m.add_argument("--sample-points", type=int, default=None)
    m.add_argument("--no-balance", action="store_true")
    m.add_argument("--device", default="cuda")
    m.set_defaults(fn=cmd_make_dataset)

    t = sub.add_parser("train", help="train Patch2Normal")
    t.add_argument("dataset")
    t.add_argument("-o", "--output", required=True)
    t.add_argument("--epochs", type=int, default=100)
    t.add_argument("--batch-size", type=int, default=64)
    t.add_argument("--device", default="cuda")
    t.set_defaults(fn=cmd_train)

    pr = sub.add_parser("predict-normals", help="learned normal regression")
    pr.add_argument("input")
    pr.add_argument("-o", "--output", required=True)
    pr.add_argument("--ckpt", default=None,
                    help="Patch2Normal weights: a flat .npz of Flax variables "
                         "(save_variables_npz) or a train checkpoint directory (its "
                         "best step); a seeded initialisation without it")
    pr.add_argument("--device", default="cuda")
    pr.set_defaults(fn=cmd_predict_normals)

    an = sub.add_parser("add-noise", help="corrupt a mesh/cloud (the app's noise buttons)")
    an.add_argument("input")
    an.add_argument("-o", "--output", required=True)
    an.add_argument("--level", type=float, default=0.3,
                    help="stdev = level x mean edge length")
    an.add_argument("--type", choices=["gaussian", "impulse"], default="gaussian")
    an.add_argument("--direction", choices=["normal", "random"], default="normal")
    an.add_argument("--seed", type=int, default=0)
    an.add_argument("--save-noise", default=None, metavar="DIR",
                    help="persist the noisy positions")
    an.add_argument("--load-noise", default=None, metavar="FILE",
                    help="re-apply a persisted realization instead of drawing")
    an.add_argument("--device", default="cuda")
    an.set_defaults(fn=cmd_add_noise)

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
    dm.add_argument("--html", default=None, metavar="FILE",
                    help="also write a standalone orbit-viewer .html (error-map "
                         "colours when --error-map is on)")
    dm.add_argument("--device", default="cuda")
    dm.set_defaults(fn=cmd_denoise_mesh)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
