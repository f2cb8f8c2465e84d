"""The GCN-denoiser cascade (torch), as ``ngpd_tpu/meshproc/gcn_denoiser.py``:

  1. a 64-face patch for every face (``extract_mesh_patches``);
  2. the DGCNN over the patches in batches;
  3. predictions normalized and rotated back to the world frame;
  4. guided normal filtering and vertex updates (``guided_normal_filter``);
  5. optionally more passes on the denoised mesh with rebuilt
     neighbourhoods, with a second network (``variables2``, the cascade's
     stage-2 weights) and filter settings (``gnf_cfg2``).

Each pass builds one centroid kNN (k = 64, self included) and shares it
between the patches and the filter.

``pmesh`` shards the patch inference over a mesh axis: every rank builds
the patches of the whole mesh, forwards its share of them and all-gathers
the predictions, so every rank ends with the whole result.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from ..collectives import all_gather
from ..config import GNFConfig, PatchConfig
from ..device import exact_float32, resolve_device
from ..models.dgcnn import DGCNN, dgcnn_from_state_dict
from ..ops.knn import knn
from ..parallel.mesh import mesh_axis
from ..utils import prof
from .bucketing import pad_mesh
from .filtering import guided_normal_filter
from .patches import extract_mesh_patches, unrotate_predictions
from .trimesh import TriMesh, face_normals_areas_centroids


def centroid_knn(mesh: TriMesh, k: int):
    """The pass's shared neighbourhood: ``(idx, mask, sqdist)`` of the k
    nearest face centroids, on the mesh's device."""
    _, _, centroids = face_normals_areas_centroids(mesh.v, mesh.f)
    nbh, d2 = knn(centroids, k)
    return nbh.idx, nbh.mask, d2


def run_dgcnn(model: DGCNN, inputs: torch.Tensor, batch_size: int) -> torch.Tensor:
    """The network over (F, 20, P) patch inputs, ``batch_size`` at a time."""
    with torch.no_grad():
        return torch.cat([model(chunk) for chunk in torch.split(inputs, batch_size)])


def predict_face_normals(
    mesh: TriMesh,
    model: DGCNN,
    patch_cfg: PatchConfig = PatchConfig(),
    batch_size: int = 720,
    pre_nbh=None,
    device=None,
    pmesh=None,
    axis: str = "points",
) -> torch.Tensor:
    """Per-face world-frame normals from the patch network, on ``device``
    (``model`` is moved there).

    With ``pmesh`` (a ``DeviceMesh``) the faces are padded to a multiple of
    8 x the size of its ``axis``; each rank forwards its contiguous share
    in chunks of ``batch_size`` and the shares are all-gathered. (The
    reference forwards a shard as one batch; at 81,920 faces one forward
    would not fit a card.)"""
    dev = resolve_device(device)
    with prof.span("ngpd.mesh.patches", dev):
        patches = extract_mesh_patches(mesh, cfg=patch_cfg, pre_nbh=pre_nbh, device=dev)
    model = model.to(dev)
    if pmesh is None:
        with prof.span("ngpd.mesh.dgcnn", dev):
            pred = run_dgcnn(model, patches.inputs, batch_size)
    else:
        group, d, rank = mesh_axis(pmesh, axis, dev)
        x = patches.inputs
        nf = x.shape[0]
        x = torch.cat([x, x.new_zeros((-nf % (d * 8),) + tuple(x.shape[1:]))])
        rows = x.shape[0] // d
        with prof.span("ngpd.mesh.dgcnn", dev):
            shard = run_dgcnn(model, x[rank * rows : (rank + 1) * rows], batch_size)
        pred = all_gather(shard, group)[:nf]
    pred = pred / torch.clamp(torch.linalg.norm(pred, dim=1, keepdim=True), min=1e-12)
    return unrotate_predictions(pred, patches.rotations)


def gcn_denoise_mesh(
    mesh: TriMesh,
    model: DGCNN,
    passes: int = 1,
    gnf_cfg: GNFConfig = GNFConfig(),
    patch_cfg: PatchConfig = PatchConfig(),
    batch_size: int = 720,
    variables2: Optional[Mapping[str, torch.Tensor]] = None,
    bucketed: bool = False,
    gnf_cfg2: Optional[GNFConfig] = None,
    device=None,
    pmesh=None,
) -> TriMesh:
    """Network-predicted normals -> guided filtering, ``passes`` times with
    rebuilt neighbourhoods; returns the denoised mesh on ``device``.

    ``variables2``: a state dict for every pass after the first (the
    cascade's stage-2 network); defaults to ``model``'s weights.
    ``gnf_cfg2``: the filter settings of every pass after the first;
    defaults to ``gnf_cfg``. ``bucketed``: pad the mesh to power-of-two
    shape buckets first (``meshproc.bucketing``); the result is the same
    mesh. ``pmesh``: shard the patch inference over the mesh's ``"points"``
    axis (``predict_face_normals``).
    """
    dev = resolve_device(device)
    exact_float32()
    with prof.span("ngpd.mesh", dev):
        mesh = mesh.to(dev)
        with prof.span("ngpd.mesh.model_build", dev):
            model = model.to(dev)
            model2 = model if variables2 is None else dgcnn_from_state_dict(variables2).to(dev)
        face_mask: Optional[torch.Tensor] = None
        out = mesh
        if bucketed:
            padded = pad_mesh(mesh)
            out, face_mask = padded.mesh, padded.face_mask
        for p in range(max(1, passes)):
            # Only when patches and filter agree on k can they share it.
            pre_nbh = None
            if patch_cfg.num_nodes == 64:
                with prof.span("ngpd.mesh.centroid_knn", dev):
                    pre_nbh = centroid_knn(out, 64)
            guidance = predict_face_normals(out, model if p == 0 else model2, patch_cfg,
                                            batch_size, pre_nbh=pre_nbh, device=dev,
                                            pmesh=pmesh)
            if face_mask is not None:
                # Sentinel faces guide with their own normals; their
                # neighbourhoods never touch real faces.
                own, _, _ = out.face_data()
                guidance = torch.where(face_mask[:, None], guidance, own)
            pass_cfg = gnf_cfg if p == 0 or gnf_cfg2 is None else gnf_cfg2
            with prof.span("ngpd.mesh.gnf", dev):
                out = guided_normal_filter(out, guidance, pass_cfg, face_mask=face_mask,
                                           pre_nbh=pre_nbh, device=dev)
        if bucketed:
            return mesh.with_vertices(out.v[: mesh.num_vertices])
    return out
