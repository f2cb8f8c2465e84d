"""Bulk patch-archive generation (torch), as ``ngpd_tpu/meshproc/collector.py``.

Folder conventions, as the reference's:

* noisy copies of ``{dir}/{name}.obj`` live at
  ``{dir}/Noise/{name}_{int(level*10)}.obj``;
* the clean twin of a noisy mesh is one directory up, the last ``_suffix``
  stripped;
* per-face patch files are ``{dir}/Noise/Patches/{name}_{faceidx}.mat``
  with {MAT, FEA, GT, ROT} (``io/matpatch.py``), and the fast archive is
  one ``.npz`` shard per mesh with ``x`` (B, 20, P), ``y`` (B, 3), ``rot``
  (B, 3, 3), ``face_index`` and ``source``, what ``learn/train_dgcnn.py``
  streams.

Patches come from one batched ``extract_mesh_patches`` call per mesh on
``device``. The noise is drawn from a ``torch.Generator`` seeded with
``seed + mesh index`` on the device (``core/noise.py::draw_noise``; other
numbers than the reference's ``jax.random``); subsampling and the crease
weighting use ``numpy.random.default_rng`` as the reference does, so the
same faces are kept.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..config import PatchConfig
from ..core.noise import draw_noise
from ..device import resolve_device
from ..io.matpatch import save_mat_patch
from ..io.obj import read_obj, save_obj
from .patches import MeshPatchBatch, extract_mesh_patches
from .trimesh import TriMesh, add_mesh_noise

PathLike = Union[str, Path]

NOISE_DIR = "Noise"
PATCH_DIR = "Patches"


def load_mesh(path: PathLike, device="cpu") -> TriMesh:
    data = read_obj(str(path))
    if data.fv is None or len(data.fv) == 0:
        raise ValueError(f"{path} has no faces — not a mesh")
    return TriMesh.from_numpy(data.v, data.fv, device=device)


def generate_noisy_meshes(
    clean_path: PathLike,
    levels: Sequence[float],
    noise_type: int = 0,
    direction: int = 0,
    seed: int = 0,
    device=None,
) -> list:
    """Write ``{dir}/Noise/{name}_{int(level*10)}.obj`` for each level, the
    draws from one generator seeded with ``seed``. Returns the paths."""
    dev = resolve_device(device)
    clean_path = Path(clean_path)
    mesh = load_mesh(clean_path, dev)
    noise_dir = clean_path.parent / NOISE_DIR
    noise_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(dev).manual_seed(seed)
    out = []
    for level in levels:
        noisy = add_mesh_noise(mesh, draw_noise(mesh.num_vertices, gen), float(level),
                               noise_type=noise_type, direction=direction)
        target = noise_dir / f"{clean_path.stem}_{int(level * 10)}.obj"
        save_obj(str(target), noisy.v.cpu().numpy(), faces=noisy.f.cpu().numpy())
        out.append(str(target))
    return out


def clean_twin_path(noisy_path: PathLike) -> Path:
    """``{dir}/Noise/{name}_{lvl}.obj`` -> ``{dir}/{name}.obj``."""
    noisy_path = Path(noisy_path)
    stem = noisy_path.stem
    if "_" not in stem:
        raise ValueError(f"noisy mesh name carries no _level suffix: {noisy_path}")
    return noisy_path.parent.parent / (stem[: stem.rfind("_")] + ".obj")


def collect_patches(
    noisy_path: PathLike,
    gt_path: Optional[PathLike] = None,
    cfg: PatchConfig = PatchConfig(),
    bucketed: bool = False,
    device=None,
) -> MeshPatchBatch:
    """Patches for every face of a noisy mesh, GT normals from the clean
    twin (found by the convention when ``gt_path`` is omitted).
    ``bucketed`` extracts on the padded mesh (``meshproc/bucketing.py``)
    and crops the outputs back to the real faces."""
    dev = resolve_device(device)
    noisy = load_mesh(noisy_path, dev)
    gt_path = Path(gt_path) if gt_path is not None else clean_twin_path(noisy_path)
    gt = load_mesh(gt_path, dev)
    if gt.num_faces != noisy.num_faces:
        raise ValueError(f"clean twin {gt_path} has {gt.num_faces} faces, noisy mesh "
                         f"{noisy.num_faces} — not the same topology")
    gt_normals, _, _ = gt.face_data()
    if not bucketed:
        return extract_mesh_patches(noisy, gt_normals=gt_normals, cfg=cfg, device=dev)

    from .bucketing import pad_mesh

    padded = pad_mesh(noisy)
    gt_pad, _, _ = padded.mesh.face_data()
    gt_pad = gt_pad.clone()
    gt_pad[: padded.num_faces] = gt_normals
    batch = extract_mesh_patches(padded.mesh, gt_normals=gt_pad, cfg=cfg, device=dev)
    nf = padded.num_faces
    return MeshPatchBatch(inputs=batch.inputs[:nf], rotations=batch.rotations[:nf],
                          y=batch.y[:nf], node_mask=batch.node_mask[:nf])


def _mat_arrays(x: np.ndarray):
    """One patch's (20, P) input -> (adjacency, features) for save_mat_patch."""
    p = x.shape[1]
    feats = x[0:17].T  # (P, 17)
    trip = x[17:20].T.astype(np.int64)  # (P, 3) local indices
    adj = np.zeros((p, p), np.float64)
    rows = np.arange(p)
    for c in range(3):
        tgt = trip[:, c]
        real = tgt != rows  # self-padding encodes "no neighbour"
        adj[rows[real], tgt[real]] = 1.0
        adj[tgt[real], rows[real]] = 1.0
    return adj, feats


def save_patch_archive(
    noisy_path: PathLike,
    batch: MeshPatchBatch,
    face_indices: Optional[np.ndarray] = None,
    out_dir: Optional[PathLike] = None,
) -> list:
    """Per-face ``.mat`` files ``{Patches}/{name}_{faceidx}.mat`` with
    {MAT, FEA, GT, ROT}; subsample with ``face_indices``. Returns the paths."""
    noisy_path = Path(noisy_path)
    out_dir = Path(out_dir) if out_dir is not None else noisy_path.parent / PATCH_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    inputs = np.asarray(torch.as_tensor(batch.inputs).cpu())
    y = np.asarray(torch.as_tensor(batch.y).cpu())
    rot = np.asarray(torch.as_tensor(batch.rotations).cpu())
    if face_indices is None:
        face_indices = np.arange(inputs.shape[0])
    paths = []
    for i in np.asarray(face_indices):
        adj, feats = _mat_arrays(inputs[int(i)])
        target = out_dir / f"{noisy_path.stem}_{int(i)}.mat"
        save_mat_patch(target, adj, feats, y[i], rotation=rot[i])
        paths.append(str(target))
    return paths


def crease_face_mask(mesh: TriMesh, angle_deg: float = 30.0) -> np.ndarray:
    """Faces adjacent to a dihedral sharper than ``angle_deg``."""
    f = mesh.f.cpu().numpy()
    n = mesh.face_data()[0].cpu().numpy()
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    e.sort(axis=1)
    owner = np.tile(np.arange(len(f)), 3)
    order = np.lexsort((e[:, 1], e[:, 0]))
    es, ow = e[order], owner[order]
    pair = np.all(es[:-1] == es[1:], axis=1)
    a, b = ow[:-1][pair], ow[1:][pair]
    sharp = np.sum(n[a] * n[b], axis=1) < np.cos(np.radians(angle_deg))
    mask = np.zeros(len(f), bool)
    mask[a[sharp]] = True
    mask[b[sharp]] = True
    return mask


def collect_patch_shard(
    noisy_path: PathLike,
    out_npz: PathLike,
    gt_path: Optional[PathLike] = None,
    max_patches: int = -1,
    cfg: PatchConfig = PatchConfig(),
    seed: int = 0,
    bucketed: bool = False,
    crease_boost: float = 0.0,
    device=None,
) -> str:
    """Every (subsampled) patch of one mesh in one ``.npz`` shard: x
    (B, 20, P) float32, y (B, 3), rot (B, 3, 3), face_index, source.
    ``crease_boost`` > 0 weights a clean-mesh crease face ``1 + crease_boost``
    against a flat one when ``max_patches`` binds."""
    batch = collect_patches(noisy_path, gt_path, cfg, bucketed=bucketed, device=device)
    nf = batch.inputs.shape[0]
    idx = np.arange(nf)
    if 0 <= max_patches < nf:
        rng = np.random.default_rng(seed)
        if crease_boost > 0.0 and gt_path is not None:
            w = np.ones(nf)
            mask = crease_face_mask(load_mesh(gt_path))[:nf]
            w[: len(mask)][mask] += crease_boost
            idx = rng.choice(nf, size=max_patches, replace=False, p=w / w.sum())
        else:
            idx = rng.choice(nf, size=max_patches, replace=False)
        idx.sort()
    out_npz = Path(out_npz)
    out_npz.parent.mkdir(parents=True, exist_ok=True)
    sel = torch.as_tensor(idx, device=batch.inputs.device)
    np.savez_compressed(
        str(out_npz),
        x=batch.inputs[sel].cpu().numpy().astype(np.float32),
        y=batch.y[sel].cpu().numpy().astype(np.float32),
        rot=batch.rotations[sel].cpu().numpy().astype(np.float32),
        face_index=idx.astype(np.int32),
        source=str(noisy_path),
    )
    return str(out_npz)


def build_mesh_dataset(
    clean_meshes: Sequence[PathLike],
    out_dir: PathLike,
    levels: Sequence[float] = (0.1, 0.2, 0.3),
    max_patches_per_mesh: int = -1,
    noise_type: int = 0,
    direction: int = 0,
    cfg: PatchConfig = PatchConfig(),
    seed: int = 0,
    noisy_meshes: Optional[Sequence[PathLike]] = None,
    crease_boost: float = 0.0,
    device=None,
) -> list:
    """Noise generation + one shard per noisy mesh. With ``noisy_meshes``
    (paired positionally with ``clean_meshes``) the noise stage is
    skipped. Returns the shard paths."""
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    if noisy_meshes is not None:
        pairs = list(zip(noisy_meshes, clean_meshes))
    else:
        pairs = [(p, clean) for m, clean in enumerate(clean_meshes)
                 for p in generate_noisy_meshes(clean, levels, noise_type, direction,
                                                seed=seed + m, device=dev)]
    return [collect_patch_shard(noisy_p, out_dir / f"{Path(noisy_p).stem}.npz",
                                gt_path=clean_p, max_patches=max_patches_per_mesh, cfg=cfg,
                                seed=seed + 1000 + s, crease_boost=crease_boost, device=dev)
            for s, (noisy_p, clean_p) in enumerate(pairs)]
