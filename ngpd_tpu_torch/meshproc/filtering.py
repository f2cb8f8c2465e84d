"""Guided normal filtering and the vertex update (torch), as
``ngpd_tpu/meshproc/filtering.py``.

``guided_normal_filter``: for ``normal_iterations`` rounds every face normal
becomes the normalized area x spatial x range weighted sum over its
neighbourhood (Gaussian weights exp(-0.5 d^2 / sigma^2)); the range
distance compares guidance normals, the accumulated normal is the guidance
on the first round and the previous filtered normal after it, and each
round ends with ``vertex_iterations`` position updates. The neighbourhood
is the centroid kNN of the initial mesh capped by the radius. The
reference runs the rounds as one ``lax.scan``; the port runs a loop.

Every mask stays a ``where``: a padded slot can hold NaN or inf, and a
multiply by a 0 mask would leave 0 * NaN = NaN in the sums.

``update_vertex_positions`` is the normal-driven vertex flow
p += mean_f n_f (n_f . (c_f - p)).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import GNFConfig
from ..device import resolve_device
from ..ops.knn import knn
from .trimesh import TriMesh, face_normals_areas_centroids


def _centroids(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return (v[f[:, 0]] + v[f[:, 1]] + v[f[:, 2]]) / 3.0


def update_vertex_positions(
    v: torch.Tensor,
    f: torch.Tensor,
    vf_idx: torch.Tensor,
    vf_mask: torch.Tensor,
    filtered_normals: torch.Tensor,
    iterations: int = 16,
    boundary_mask: Optional[torch.Tensor] = None,
    fixed_boundary: bool = False,
) -> torch.Tensor:
    """Iterate p += mean over incident faces of n (n . (c - p)). With
    ``fixed_boundary`` the vertices where ``boundary_mask`` (V,) is True
    keep their positions in every iteration."""
    nf = filtered_normals[vf_idx]  # (V, D, 3)
    m = vf_mask[..., None]
    deg = torch.clamp(torch.sum(m.to(v.dtype), dim=1), min=1.0)
    pinned = boundary_mask[:, None] if fixed_boundary and boundary_mask is not None else None
    pts = v
    for _ in range(iterations):
        cf = _centroids(pts, f)[vf_idx]
        dot = torch.sum(nf * (cf - pts[:, None, :]), dim=-1)
        contrib = torch.where(m, nf * dot[..., None], 0.0)
        new = pts + torch.sum(contrib, dim=1) / deg
        pts = new if pinned is None else torch.where(pinned, pts, new)
    return pts


def _mean_adjacent_distance(centroids, ff_idx, ff_mask, face_mask):
    """Mean distance between edge-adjacent centroids; a pair with either
    face outside ``face_mask`` is left out."""
    d = torch.linalg.norm(centroids[ff_idx] - centroids[:, None, :], dim=-1)
    m = ff_mask.to(d.dtype)
    if face_mask is not None:
        fm = face_mask.to(d.dtype)
        m = m * fm[:, None] * fm[ff_idx]
    d = torch.where(m > 0, d, 0.0)
    return torch.sum(d), torch.clamp(torch.sum(m), min=1.0)


def _gnf_radius_sigma(mesh: TriMesh, multiple: float,
                      face_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean adjacent-centroid distance x multiple; ``face_mask`` leaves the
    padded sentinel faces out."""
    _, _, centroids = mesh.face_data()
    ff_idx, ff_mask = mesh.face_face_adjacency()
    total, count = _mean_adjacent_distance(centroids, ff_idx, ff_mask, face_mask)
    return multiple * total / count


def guided_normal_filter(
    mesh: TriMesh,
    guidance_normals: torch.Tensor,
    cfg: GNFConfig = GNFConfig(),
    neighbors: int = 64,
    face_mask: Optional[torch.Tensor] = None,
    pre_nbh=None,
    device=None,
) -> TriMesh:
    """Denoise a mesh given per-face guidance normals (e.g. the network's
    predictions); returns the mesh with updated vertex positions, on
    ``device``.

    ``pre_nbh``: optional precomputed ``(idx, mask, sqdist)`` centroid kNN
    (k = ``neighbors``), shared with patch extraction.
    """
    dev = resolve_device(device)
    mesh = mesh.to(dev)
    guidance_normals = guidance_normals.to(dev)
    if face_mask is not None:
        face_mask = face_mask.to(dev)
    v, f = mesh.v, mesh.f
    vf_idx, vf_mask = mesh.vertex_face_adjacency()
    radius = _gnf_radius_sigma(mesh, cfg.radius_scale, face_mask)

    # Fixed neighbourhoods from the initial mesh.
    if pre_nbh is None:
        _, _, centroids0 = mesh.face_data()
        nbh, d2 = knn(centroids0, neighbors)
        nb_idx, nb_mask = nbh.idx, nbh.mask
    else:
        nb_idx, nb_mask, d2 = (t.to(dev) for t in pre_nbh)
    in_radius = nb_mask & (d2 <= radius**2)

    if cfg.guidance_smooth_iterations > 0:
        # Bilateral smoothing of the guidance field: area x spatial x range
        # weights over the same neighbourhood. The query face is its own
        # first neighbour (d2 = 0, r2 = 0), so the sum carries the self
        # term with weight area_i.
        _, areas0, _ = mesh.face_data()
        sigma_s0 = _gnf_radius_sigma(mesh, cfg.sigma_s_scale, face_mask)
        w_sp = areas0[nb_idx] * torch.exp(-0.5 * d2 / torch.clamp(sigma_s0**2, min=1e-30))
        w_sp = torch.where(in_radius, w_sp, 0.0)
        sg2 = cfg.guidance_smooth_sigma**2
        g = guidance_normals
        for _ in range(cfg.guidance_smooth_iterations):
            gj = g[nb_idx]
            r2 = torch.sum((g[:, None, :] - gj) ** 2, dim=-1)
            w = w_sp * torch.exp(-0.5 * r2 / sg2)
            acc = torch.sum(w[..., None] * gj, dim=1)
            nrm = torch.linalg.norm(acc, dim=1, keepdim=True)
            g = torch.where(nrm > 1e-12, acc / torch.clamp(nrm, min=1e-12), g)
        guidance_normals = g

    ff_idx, ff_mask = mesh.face_face_adjacency()
    g_j = guidance_normals[nb_idx]  # (F, K, 3), gathered once
    range_dis2 = torch.sum((guidance_normals[:, None, :] - g_j) ** 2, dim=-1)
    range_w = torch.exp(-0.5 * range_dis2 / (cfg.sigma_r**2))
    cur_v = v
    for it in range(cfg.normal_iterations):
        normals, areas, centroids = face_normals_areas_centroids(cur_v, f)
        # sigma_s from the current geometry, over real faces only.
        total, count = _mean_adjacent_distance(centroids, ff_idx, ff_mask, face_mask)
        sigma_s = cfg.sigma_s_scale * total / count
        sp2 = torch.sum((centroids[:, None, :] - centroids[nb_idx]) ** 2, dim=-1)
        spatial_w = torch.exp(-0.5 * sp2 / torch.clamp(sigma_s**2, min=1e-30))
        w = areas[nb_idx] * spatial_w * range_w
        w = torch.where(in_radius, w, 0.0)
        # The first round accumulates the guidance, later ones the previous
        # round's output.
        src = g_j if it == 0 else normals[nb_idx]
        filt = torch.sum(w[..., None] * src, dim=1)
        # Zero-weight rescue: a face whose every weight underflows keeps
        # its own normal (normalizing a flushed accumulator against the
        # floor would mint huge "normals").
        nrm_f = torch.linalg.norm(filt, dim=1, keepdim=True)
        filt = torch.where(nrm_f > 1e-12, filt / torch.clamp(nrm_f, min=1e-12), normals)
        cur_v = update_vertex_positions(cur_v, f, vf_idx, vf_mask, filt, cfg.vertex_iterations)
    return mesh.with_vertices(cur_v)
