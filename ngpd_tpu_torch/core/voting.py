"""Tensor voting, eigenanalysis and feature classification (torch), as
``ngpd_tpu/core/voting.py``: pure functions over dense (N, k)
neighbourhoods. Eigen conventions are ``torch.linalg.eigh``'s: ascending
eigenvalues, eigenvectors in columns, so ``eigvec[..., 0]`` is the
smallest-eigenvalue eigenvector used as the edge direction.

Every contraction over the neighbour axis is a sum of products written
out (``_sum_outer``), not a matrix product: the terms have length 3 and
the CPU and the card then round alike.

The builders' ``src_points`` / ``src_normals`` are the reference's sharded
arguments: a caller whose row arrays hold only its own query rows
(``parallel/sharded.py``) gathers the neighbours from these whole arrays.
They default to the query arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.eigh3 import eigh3x3
from ..ops.neighbors import Neighborhood, normalize, outer3

FACE, EDGE, CORNER = 0, 1, 2


class Decomposition(NamedTuple):
    """Eigenpairs of per-point 3x3 voting tensors."""

    eigval: torch.Tensor  # (N, 3) ascending
    eigvec: torch.Tensor  # (N, 3, 3) columns


def _sum_outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a_k b_k^T: (N, K, 3) x (N, K, 3) -> (N, 3, 3)."""
    return torch.sum(a[..., :, None] * b[..., None, :], dim=1)


# ---------------------------------------------------------------------------
# Decomposition-derived features
# ---------------------------------------------------------------------------


def nvt_features(d: Decomposition):
    """(planarity, linearity, sphericity) from the sorted eigenvalues."""
    lam1 = d.eigval[:, 2]  # largest
    lam2 = d.eigval[:, 1]
    lam3 = d.eigval[:, 0]  # smallest
    safe = torch.where(torch.abs(lam1) > 1e-30, lam1, 1e-30)
    linearity = (lam2 - lam3) / safe
    planarity = (lam1 - lam2) / safe
    sphericity = lam3 / safe
    return planarity, linearity, sphericity


def classes(d: Decomposition, scale: float = 0.2) -> torch.Tensor:
    """argmax of [scale*planarity, linearity, sphericity] ->
    {0: face, 1: edge, 2: corner} as int32, the first maximum winning."""
    planarity, linearity, sphericity = nvt_features(d)
    plan = planarity * scale
    cls = torch.zeros_like(plan, dtype=torch.int32)
    cls = torch.where(linearity > plan, 1, cls)
    cls = torch.where(sphericity > torch.maximum(plan, linearity), 2, cls)
    return cls.to(torch.int32)


def md_features(d: Decomposition) -> torch.Tensor:
    """Eigenvalue-threshold classes {0: none, 1: flat, 2: edge, 3: corner},
    applied in the reference's write order (corner wins)."""
    desc = torch.flip(d.eigval, dims=(1,))
    e1, e2 = desc[:, 1], desc[:, 2]
    char = torch.zeros(d.eigval.shape[0], dtype=torch.int32, device=d.eigval.device)
    char = torch.where((e1 < 0.01) & (e2 < 0.001), 1, char)
    char = torch.where((e1 > 0.01) & (e2 < 0.1), 2, char)
    char = torch.where(e2 > 0.1, 3, char)
    return char.to(torch.int32)


def vu_features(d: Decomposition, tau: float) -> torch.Tensor:
    """(eigval < tau).sum % 3."""
    return (torch.sum(d.eigval < tau, dim=1) % 3).to(torch.int32)


def better_vu_features(d: Decomposition, mean_graph_edge_length, k: int = 6) -> torch.Tensor:
    """The tau = 16/k * l^2 variant."""
    tau = 16.0 / k * mean_graph_edge_length**2
    return (torch.sum(d.eigval < tau, dim=1) % 3).to(torch.int32)


def vu_smoothed_normals(d: Decomposition, n: torch.Tensor, tau: float = 0.3,
                        damping: float = 3.0) -> torch.Tensor:
    """n' = normalize(damping * n + sum_i [lam_i > tau] (e_i . n) e_i)."""
    lam = torch.flip(d.eigval, dims=(1,))  # (N, 3) descending
    vecs = torch.flip(d.eigvec, dims=(2,))  # columns descending
    keep = (lam > tau).to(n.dtype)
    proj = torch.sum(vecs * n[:, :, None], dim=1)  # (N, 3): e_i . n per column
    contrib = torch.sum((keep * proj)[:, None, :] * vecs, dim=2)
    return normalize(damping * n + contrib)


def r_inv(d: Decomposition, n: torch.Tensor) -> torch.Tensor:
    """Patch-alignment rotation R^{-1}: rows of R are the eigenvectors by
    descending eigenvalue, the first row's sign fixed to the point normal,
    the last row flipped where det(R) < 0; returned transposed."""
    rows = torch.flip(d.eigvec.transpose(1, 2), dims=(1,))  # (N, 3 rows, 3)
    sign0 = torch.where(torch.sum(rows[:, 0, :] * n, dim=1) < 0, -1.0, 1.0)
    rows = rows * sign0[:, None, None]
    det = torch.sum(rows[:, 0] * torch.linalg.cross(rows[:, 1], rows[:, 2]), dim=1)
    flip2 = torch.where(det < 0, -1.0, 1.0)
    rows = torch.cat([rows[:, 0:2], rows[:, 2:3] * flip2[:, None, None]], dim=1)
    return rows.transpose(1, 2)


# ---------------------------------------------------------------------------
# Voting-tensor builders
# ---------------------------------------------------------------------------


def _src(rows: torch.Tensor, src: Optional[torch.Tensor]) -> torch.Tensor:
    return rows if src is None else src


def pvt(points: torch.Tensor, nbh: Neighborhood,
        src_points: Optional[torch.Tensor] = None) -> Decomposition:
    """Plain neighbour covariance about the neighbours' own mean."""
    vj = nbh.gather(_src(points, src_points))
    center = nbh.mean(vj)
    dv = vj - center[:, None, :]
    dv = torch.where(nbh.mask[..., None], dv, 0.0)
    return Decomposition(*eigh3x3(_sum_outer(dv, dv)))


def nvt(nbh: Neighborhood, n: torch.Tensor,
        src_normals: Optional[torch.Tensor] = None) -> Decomposition:
    """Mean outer product of the neighbour normals."""
    nj = nbh.gather(_src(n, src_normals))
    w = nbh.mask.to(nj.dtype)
    t = _sum_outer(nj * w[..., None], nj)
    t = t / torch.clamp(nbh.degree(), min=1.0)[:, None, None]
    return Decomposition(*eigh3x3(t))


def _acos_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.acos(torch.clamp(torch.sum(a * b, dim=-1), -1.0, 1.0))


def _weighted_nvt(nj, w) -> torch.Tensor:
    """sum_j w_ij nj nj^T / max(sum_j w_ij, 1) for boolean weights w."""
    wsum = torch.sum(w, dim=1).to(nj.dtype)
    t = _sum_outer(nj * w[..., None].to(nj.dtype), nj)
    return t / torch.clamp(wsum, min=1.0)[:, None, None]


def normal_filtered_nvt(nbh: Neighborhood, n: torch.Tensor, rho: float = 0.9,
                        src_normals: Optional[torch.Tensor] = None) -> Decomposition:
    """NVT with binary weight acos(ni.nj) <= rho; zero-weight rows fall
    back to the own-normal tensor ni ni^T."""
    nj = nbh.gather(_src(n, src_normals))
    w = (_acos_dot(n[:, None, :], nj) <= rho) & nbh.mask
    t = _weighted_nvt(nj, w)
    t = torch.where((torch.sum(w, dim=1) == 0)[:, None, None], outer3(n, n), t)
    return Decomposition(*eigh3x3(t))


def _offset_angle_weights(points, nbh: Neighborhood, vj, nj, rho: float) -> torch.Tensor:
    """Boolean weights acos(|normalize(vj - vi) . nj|) > rho; rows whose
    weights all vanish get every valid neighbour."""
    dv = normalize(vj - points[:, None, :])
    ang = torch.acos(torch.clamp(torch.abs(torch.sum(dv * nj, dim=-1)), -1.0, 1.0))
    w = (ang > rho) & nbh.mask
    return torch.where((torch.sum(w, dim=1) == 0)[:, None], nbh.mask, w)


def better_filtered_nvt(points: torch.Tensor, nbh: Neighborhood, n: torch.Tensor,
                        rho: float = 0.9, src_points: Optional[torch.Tensor] = None,
                        src_normals: Optional[torch.Tensor] = None) -> Decomposition:
    """NVT weighted by acos(|normalize(vj-vi) . nj|) > rho, with the
    zero-weight rescue."""
    nj = nbh.gather(_src(n, src_normals))
    w = _offset_angle_weights(points, nbh, nbh.gather(_src(points, src_points)), nj, rho)
    return Decomposition(*eigh3x3(_weighted_nvt(nj, w)))


def _weighted_pvt(vj, w):
    """Covariance about the weighted neighbour mean for boolean weights;
    returns (tensor, weight sums)."""
    wf = w.to(vj.dtype)
    wsum = torch.sum(wf, dim=1)
    center = torch.sum(wf[..., None] * vj, dim=1) / torch.clamp(wsum, min=1.0)[:, None]
    dv = vj - center[:, None, :]
    t = _sum_outer(dv * wf[..., None], dv)
    return t / torch.clamp(wsum, min=1.0)[:, None, None], wsum


def normal_filtered_pvt(points: torch.Tensor, nbh: Neighborhood, n: torch.Tensor,
                        rho: float = 0.9, src_points: Optional[torch.Tensor] = None,
                        src_normals: Optional[torch.Tensor] = None) -> Decomposition:
    """Weighted covariance about the weighted neighbour mean, weight
    acos(ni.nj) <= rho; zero-weight rows take every valid neighbour, and
    rows with no valid neighbour at all the analytic cross-sample tensor."""
    vj = nbh.gather(_src(points, src_points))
    nj = nbh.gather(_src(n, src_normals))
    w = (_acos_dot(n[:, None, :], nj) <= rho) & nbh.mask
    w = torch.where((torch.sum(w, dim=1) == 0)[:, None], nbh.mask, w)
    t, wsum = _weighted_pvt(vj, w)
    s1 = torch.linalg.cross(n, points)
    s2 = torch.linalg.cross(n, s1)
    rescue = 2.0 * (outer3(s1, s1) + outer3(s2, s2))
    t = torch.where((wsum == 0)[:, None, None], rescue, t)
    return Decomposition(*eigh3x3(t))


def better_filtered_pvt(points: torch.Tensor, nbh: Neighborhood, n: torch.Tensor,
                        rho: float = 0.9, src_points: Optional[torch.Tensor] = None,
                        src_normals: Optional[torch.Tensor] = None) -> Decomposition:
    """Covariance weighted by acos(|normalize(dv) . nj|) > rho, with the
    zero-weight rescue."""
    vj = nbh.gather(_src(points, src_points))
    w = _offset_angle_weights(points, nbh, vj, nbh.gather(_src(n, src_normals)), rho)
    t, _ = _weighted_pvt(vj, w)
    return Decomposition(*eigh3x3(t))


def md_transformation(points: torch.Tensor, nbh: Neighborhood, n: torch.Tensor,
                      mass: torch.Tensor, sigma_inv: float = 3.0,
                      src_points: Optional[torch.Tensor] = None,
                      src_normals: Optional[torch.Tensor] = None):
    """The paper's patch voting tensor: scale the patch to unit radius,
    reflect neighbour normals about the plane spanned by dv
    (n' = 2(n.w)w - n, w = normalize((dv x n) x dv)), weight by
    mu = (area/maxArea) * exp(-sigma_inv ||dv||), sum outer products, eigh.

    ``mass`` is gathered whole, as the reference gathers it.

    Returns (Decomposition, scale_factors (N,)).
    """
    vj = nbh.gather(_src(points, src_points))
    dv = vj - points[:, None, :]
    dist = torch.linalg.norm(dv, dim=-1)
    max_dist = torch.amax(torch.where(nbh.mask, dist, 0.0), dim=1)
    scale = 1.0 / torch.clamp(max_dist, min=1e-30)
    dv_s = dv * scale[:, None, None]
    nj = nbh.gather(_src(n, src_normals))
    w = normalize(torch.linalg.cross(torch.linalg.cross(dv_s, nj), dv_s))
    nj_ref = 2.0 * torch.sum(nj * w, dim=-1, keepdim=True) * w - nj
    areas = nbh.gather(mass) * (scale**2)[:, None]
    max_area = torch.amax(torch.where(nbh.mask, areas, 0.0), dim=1)
    ddcs = torch.linalg.norm(dv_s, dim=-1)
    mu = (areas / torch.clamp(max_area, min=1e-30)[:, None]) * torch.exp(-ddcs * sigma_inv)
    mu = torch.where(nbh.mask, mu, 0.0)
    t = _sum_outer(nj_ref * mu[..., None], nj_ref)
    return Decomposition(*eigh3x3(t)), scale


vu_filtered_normals = vu_smoothed_normals
