"""Mesh patches for the legacy DGCNN (torch), as ``ngpd_tpu/meshproc/patches.py``.

One batched pass builds the (F, 20, 64) network inputs:

  * membership: the 64 nearest centroids, masked to those within
    r = sqrt(center_area * radius_factor) of the centre face;
  * alignment: the reflected-normal voting tensor with weights
    (area / maxArea) * exp(-3 ||dc||); its eigenvectors by descending
    eigenvalue are the rows of R, the first row's sign set by the centre
    normal and the determinant made positive;
  * 17 node features: the centroid (3, as (x+1)/2 in the unit patch
    frame), the normal (3, as (n+1)/2), area / r^2, the degree feature
    (((deg - 12)/6) + 1)/2 and the 3x3 corner coordinates;
  * rows 17:20: up to 3 edge-adjacent neighbours as indices local to the
    patch, padded by duplication, self where there is none.

Where two eigenvalues of the voting tensor lie close, their eigenvectors
are ill-conditioned: a rounding change of the tensor moves a float32
solve's eigenvectors by about 1e-5 over the relative eigen gap, in the
reference as in the port (where they coincide, as on a planar patch, any
orthonormal pair of their plane is a solution). So R and the rotated
features agree with the reference where the gap is clear, and the
world-frame results within the cascade's own float32 spread.

The reference maps the query faces in chunks of 16,384, a TPU
lane-padding bound. The port builds all faces at once: at 81,920 faces
the largest block, the (F, 64, 3, 64) adjacency match, is 1 GB of bools.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import PatchConfig
from ..device import exact_float32, resolve_device
from ..ops.eigh3 import eigh3x3
from ..ops.knn import knn
from ..ops.neighbors import normalize
from .trimesh import TriMesh, face_normals_areas_centroids


class MeshPatchBatch(NamedTuple):
    inputs: torch.Tensor  # (F, 20, P) the DGCNN input layout
    rotations: torch.Tensor  # (F, 3, 3) patch frame R (world -> patch)
    y: torch.Tensor  # (F, 3) rotated GT center normal
    node_mask: torch.Tensor  # (F, P)


def voting_tensor(dv, nj, areas_j, mask) -> torch.Tensor:
    """(F, 3, 3) reflected-normal voting tensor of each patch. dv: (F, P, 3)
    scaled centroid offsets; nj: (F, P, 3) normals; areas_j, mask: (F, P)."""
    w = normalize(torch.linalg.cross(torch.linalg.cross(dv, nj, dim=-1), dv, dim=-1))
    n_ref = 2.0 * torch.sum(nj * w, dim=-1, keepdim=True) * w - nj
    max_area = torch.amax(torch.where(mask, areas_j, 0.0), dim=1)
    mu = (areas_j / torch.clamp(max_area, min=1e-30)[:, None]) * torch.exp(
        -3.0 * torch.linalg.norm(dv, dim=-1))
    mu = torch.where(mask, mu, 0.0)
    return torch.einsum("fpi,fp,fpj->fij", n_ref, mu, n_ref)


def _alignment_rotation(t, center_normal):
    """The patch frame R from the voting tensor t: (F, 3, 3) and the centre
    normal (F, 3)."""
    _, eigvec = eigh3x3(t)
    # Rows of R = eigenvectors by descending eigenvalue.
    rows = torch.flip(eigvec.transpose(1, 2), dims=(1,))
    sign0 = torch.where(torch.sum(rows[:, 0, :] * center_normal, dim=1) < 0, -1.0, 1.0)
    rows = rows * sign0[:, None, None]
    # det(R) as the triple product: R is orthonormal, so only its sign
    # matters and the two agree on it.
    det = torch.sum(rows[:, 0, :] * torch.linalg.cross(rows[:, 1, :], rows[:, 2, :], dim=-1),
                    dim=-1)
    flip2 = torch.where(det < 0, -1.0, 1.0)
    return torch.cat([rows[:, :2, :], rows[:, 2:, :] * flip2[:, None, None]], dim=1)


def _extract_rows(member, mask, centroids, radius, normals, gt_n, v, f, areas, deg,
                  ff_idx, ff_mask, p: int) -> MeshPatchBatch:
    nf = member.shape[0]
    c_j = centroids[member]  # (F, P, 3)
    n_j = normals[member]
    a_j = areas[member]
    dv = (c_j - centroids[:, None, :]) / radius[:, None, None]
    r = _alignment_rotation(voting_tensor(dv, n_j, a_j, mask), normals)

    # Aligned geometry in the unit patch frame.
    corners = v[f[member]]  # (F, P, 3 corners, 3)
    rel = (corners - centroids[:, None, None, :]) / radius[:, None, None, None]
    corners_al = torch.einsum("fij,fpcj->fpci", r, rel)
    normals_al = torch.einsum("fij,fpj->fpi", r, n_j)
    centers_al = torch.mean(corners_al, dim=2)

    deg_feat = (((deg[member] - 12.0) / 6.0) + 1.0) / 2.0
    feats = torch.cat([
        (centers_al + 1.0) / 2.0,  # 0:3
        (normals_al + 1.0) / 2.0,  # 3:6
        (a_j / torch.clamp(radius**2, min=1e-30)[:, None])[..., None],  # 6
        deg_feat[..., None],  # 7
        (corners_al.reshape(nf, p, 9) + 1.0) / 2.0,  # 8:17
    ], dim=-1)
    feats = torch.where(mask[..., None], feats, 0.0)

    # Rows 17:20: local positions of up to 3 edge-adjacent faces.
    adj = ff_idx[member]  # (F, P, 3) global
    adj_ok = ff_mask[member]
    eq = adj[..., None] == member[:, None, None, :]  # (F, P, 3, P)
    present = torch.any(eq & mask[:, None, None, :], dim=-1)
    local = torch.argmax(eq.to(torch.uint8), dim=-1).to(torch.float32)  # first match
    ok = adj_ok & present
    self_idx = torch.arange(p, dtype=torch.float32, device=v.device)[None, :].expand(nf, p)
    local = torch.where(ok, local, torch.nan)
    # Valid entries first (stable), then the last valid one repeated; none
    # -> self.
    order = torch.argsort(torch.where(ok, 0, 1), dim=-1, stable=True)
    local_sorted = torch.take_along_dim(local, order, dim=-1)
    n_ok = torch.sum(ok, dim=-1)
    fill0 = torch.where(n_ok >= 1, local_sorted[..., 0], self_idx)
    fill1 = torch.where(n_ok >= 2, local_sorted[..., 1], fill0)
    fill2 = torch.where(n_ok >= 3, local_sorted[..., 2], fill1)
    nbr_rows = torch.stack([fill0, fill1, fill2], dim=-1)

    inputs = torch.cat([feats, nbr_rows], dim=-1).transpose(1, 2)  # (F, 20, P)
    y = torch.einsum("fij,fj->fi", r, gt_n)
    return MeshPatchBatch(inputs=inputs, rotations=r, y=y, node_mask=mask)


def extract_mesh_patches(
    mesh: TriMesh,
    gt_normals: Optional[torch.Tensor] = None,
    cfg: PatchConfig = PatchConfig(),
    pre_nbh=None,
    device=None,
) -> MeshPatchBatch:
    """One 64-face patch per face of the mesh, DGCNN-ready, on ``device``.

    ``pre_nbh``: optional precomputed ``(idx, mask, sqdist)`` centroid kNN
    (k = cfg.num_nodes), shared with the guided filter.
    """
    dev = resolve_device(device)
    exact_float32()
    mesh = mesh.to(dev)
    v, f = mesh.v, mesh.f
    ff_idx, ff_mask = mesh.face_face_adjacency()
    normals, areas, centroids = face_normals_areas_centroids(v, f)
    radius = torch.sqrt(areas * cfg.radius_factor)
    if pre_nbh is None:
        nbh, d2 = knn(centroids, cfg.num_nodes)
        nb_idx, nb_mask = nbh.idx, nbh.mask
    else:
        nb_idx, nb_mask, d2 = (t.to(dev) for t in pre_nbh)
    mask = nb_mask & (d2 <= (radius**2)[:, None])
    deg = torch.sum(mask, dim=1).to(torch.float32)  # radius-neighbour count
    gt_n = normals if gt_normals is None else gt_normals.to(dev)
    # member = nb_idx: global face ids, column 0 the centre.
    return _extract_rows(nb_idx, mask, centroids, radius, normals, gt_n, v, f, areas, deg,
                         ff_idx, ff_mask, cfg.num_nodes)


def unrotate_predictions(pred: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """Patch-frame normals back to the world: n = R^T y, normalized."""
    out = torch.einsum("fji,fj->fi", rotations, pred)
    return out / torch.clamp(torch.linalg.norm(out, dim=1, keepdim=True), min=1e-12)
