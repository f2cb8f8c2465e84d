"""Class-specific normal-guided vertex update steps (torch), as
``ngpd_tpu/core/denoise.py``, on dense ``(N, k, 3)`` gathers.

Every step has the same shape: assemble one 3x3 normal-equation system
per point from gathered neighbour normals, solve (keeping the old
position when singular), damp the displacement by alpha and reject it
entirely when its norm reaches the threshold ``d``. Every step evaluates
for ALL points and the caller selects per point by class id.

``src_points`` / ``src_normals`` (every step but ``dummy_step``) are the
gather sources of a sharded caller whose row arrays hold only its own
query rows; they default to the query arrays.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.neighbors import Neighborhood, matvec3, outer3
from ..ops.solve3 import solve3x3_guarded
from ..ops.steps import STEP_NAMES


def _clamp_step(vi, opt, alpha: float, d, strict: bool) -> torch.Tensor:
    """di = (opt - vi) * alpha; keep vi when ||di|| >= d (flat_step keeps
    a step of exactly d)."""
    di = (opt - vi) * alpha
    norm = torch.linalg.norm(di, dim=-1)
    ok = norm < d if strict else norm <= d
    return torch.where(ok[:, None], vi + di, vi)


def _weighted_normal_system(njw, nj, vj):
    """(sum_j njw nj^T, sum_j njw (nj . vj)): (N, 3, 3), (N, 3)."""
    a = torch.sum(njw[..., :, None] * nj[..., None, :], dim=1)
    b = torch.sum(njw * torch.sum(nj * vj, dim=-1, keepdim=True), dim=1)
    return a, b


def _gathered(points, n, nbh: Neighborhood, src_points, src_normals):
    """(vj, nj) from the sources, the query arrays by default."""
    return (nbh.gather(points if src_points is None else src_points),
            nbh.gather(n if src_normals is None else src_normals))


def corner_step(points, nbh: Neighborhood, n, d, alpha: float = 0.1,
                src_points=None, src_normals=None) -> torch.Tensor:
    """Solve (sum nj nj^T) v = sum (nj nj^T) vj."""
    vj, nj = _gathered(points, n, nbh, src_points, src_normals)
    njm = nj * nbh.mask.to(nj.dtype)[..., None]
    a, b = _weighted_normal_system(njm, nj, vj)
    opt, _ = solve3x3_guarded(a, b, points)
    return _clamp_step(points, opt, alpha, d, strict=True)


def edge_step(points, nbh: Neighborhood, n, edge_vectors, d, alpha: float = 0.1,
              src_points=None, src_normals=None) -> torch.Tensor:
    """Corner solve with positions and normals projected off the edge
    direction, plus an edge-pinning term. ``edge_vectors`` is the
    smallest-eigenvalue NVT eigenvector, the crease direction."""
    y = edge_vectors
    vi = points
    vj, nj = _gathered(points, n, nbh, src_points, src_normals)
    yk = y[:, None, :]
    vj_pi = vj - torch.sum((vj - vi[:, None, :]) * yk, dim=-1, keepdim=True) * yk
    nj_pi = nj - torch.sum(nj * yk, dim=-1, keepdim=True) * yk
    m = nbh.mask.to(nj.dtype)
    deg = torch.sum(m, dim=1)
    y_o = outer3(y, y)
    a, b = _weighted_normal_system(nj_pi * m[..., None], nj_pi, vj_pi)
    a = a + deg[:, None, None] * y_o
    b = b + deg[:, None] * matvec3(y_o, vi)
    opt, _ = solve3x3_guarded(a, b, points)
    return _clamp_step(points, opt, alpha, d, strict=True)


def _neighbor_spread(vj, mask) -> torch.Tensor:
    """Max distance of the gathered valid neighbours from their global
    mean: the flat and new steps' delta when the caller gives none."""
    w = mask.to(vj.dtype)[..., None]
    center = torch.sum(vj * w, dim=(0, 1)) / torch.clamp(torch.sum(w), min=1.0)
    return torch.max(torch.where(mask, torch.linalg.norm(vj - center, dim=-1), 0.0))


def flat_step(points, nbh: Neighborhood, n, d, alpha: float = 0.1,
              delta: Optional[torch.Tensor] = None, src_points=None,
              src_normals=None) -> torch.Tensor:
    """Bilateral normal-position weighting:
    Wij = exp(-16||ni-nj||^2/delta^2) * exp(-4||vj-vi||^2/delta^2),
    di = sum Wij (nj.(vj-vi)) ni / sum Wij * alpha."""
    vj, nj = _gathered(points, n, nbh, src_points, src_normals)
    dist = vj - points[:, None, :]
    if delta is None:
        delta = _neighbor_spread(vj, nbh.mask)
    d2 = torch.clamp(torch.as_tensor(delta, dtype=points.dtype) ** 2, min=1e-30)
    similarity = torch.exp(-16.0 * torch.sum((n[:, None, :] - nj) ** 2, dim=-1) / d2)
    closeness = torch.exp(-4.0 * torch.sum(dist**2, dim=-1) / d2)
    wij = torch.where(nbh.mask, similarity * closeness, 0.0)
    dot = torch.sum(nj * dist, dim=-1)
    summed = torch.sum((wij * dot)[..., None] * n[:, None, :], dim=1)
    wsum = torch.sum(wij, dim=1)
    di = summed / torch.clamp(wsum, min=1e-30)[:, None] * alpha
    norm = torch.linalg.norm(di, dim=-1)
    di = torch.where((norm <= d)[:, None], di, 0.0)
    return points + di


def _three_term_system(points, nbh: Neighborhood, n, wij, src_points=None, src_normals=None):
    """Shared assembly of the feature and new steps:
    A = (I + ni ni^T) + sum_j w_ij nj nj^T + |N(i)| ni ni^T
    b = (vi + ni ni^T vi) + ni ni^T sum_j w_ij vj + sum_j w_ij nj nj^T vj.
    The cardinality is the raw neighbour count, not weighted."""
    vi = points
    vj, nj = _gathered(points, n, nbh, src_points, src_normals)
    ni_o = outer3(n, n)
    w = torch.where(nbh.mask, wij, 0.0)
    summed_nj_o, summed_nj_o_vj = _weighted_normal_system(nj * w[..., None], nj, vj)
    cardinality = nbh.degree()
    summed_vj = torch.sum(w[..., None] * vj, dim=1)
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    a = eye[None] + ni_o + summed_nj_o + cardinality[:, None, None] * ni_o
    b = vi + matvec3(ni_o, vi) + matvec3(ni_o, summed_vj) + summed_nj_o_vj
    return a, b


def feature_step(points, nbh: Neighborhood, n, d, alpha: float = 0.1,
                 src_points=None, src_normals=None) -> torch.Tensor:
    """The unweighted three-term system."""
    ones = torch.ones(nbh.mask.shape, dtype=points.dtype, device=points.device)
    a, b = _three_term_system(points, nbh, n, ones, src_points, src_normals)
    opt, _ = solve3x3_guarded(a, b, points)
    return _clamp_step(points, opt, alpha, d, strict=True)


def new_step(points, nbh: Neighborhood, n, d, alpha: float = 0.1,
             delta: Optional[torch.Tensor] = None, src_points=None,
             src_normals=None) -> torch.Tensor:
    """feature_step with the likeliness weight
    w_ij = exp(-9 (nj.(vj-vi))^2 / delta^2)."""
    vj, nj = _gathered(points, n, nbh, src_points, src_normals)
    if delta is None:
        delta = _neighbor_spread(vj, nbh.mask)
    d2 = torch.clamp(torch.as_tensor(delta, dtype=points.dtype) ** 2, min=1e-30)
    plane_dist = torch.sum(nj * (vj - points[:, None, :]), dim=-1)
    likeliness = torch.exp(-9.0 * plane_dist**2 / d2)
    a, b = _three_term_system(points, nbh, n, likeliness, src_points, src_normals)
    opt, _ = solve3x3_guarded(a, b, points)
    return _clamp_step(points, opt, alpha, d, strict=True)


def dummy_step(points, nbh: Neighborhood, n, d, alpha: float = 0.1) -> torch.Tensor:
    """Identity."""
    del nbh, n, d, alpha
    return points


def class_step(name: str, points, nbh: Neighborhood, n, edge_vectors, d, alpha: float,
               delta: Optional[torch.Tensor] = None, src_points=None,
               src_normals=None) -> torch.Tensor:
    """The step ``name`` (one of ``STEP_NAMES``) for every point: flat and
    new with ``delta``, edge along ``edge_vectors``."""
    src = {"src_points": src_points, "src_normals": src_normals}
    if name in ("flat", "new"):
        step = flat_step if name == "flat" else new_step
        return step(points, nbh, n, d, alpha, delta=delta, **src)
    if name == "edge":
        return edge_step(points, nbh, n, edge_vectors, d, alpha, **src)
    if name == "corner":
        return corner_step(points, nbh, n, d, alpha, **src)
    if name == "feature":
        return feature_step(points, nbh, n, d, alpha, **src)
    if name == "dummy":
        return dummy_step(points, nbh, n, d, alpha)
    raise ValueError(f"unknown step {name!r}; expected one of {STEP_NAMES}")


def pick_by_class(cls: torch.Tensor, results) -> torch.Tensor:
    """Each point's row of ``results[cls]``: the step of its class."""
    return torch.where(
        (cls == 0)[:, None], results[0],
        torch.where((cls == 1)[:, None], results[1], results[2]),
    )
