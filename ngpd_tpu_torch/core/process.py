"""High-level processing APIs (torch), as ``ngpd_tpu/core/process.py``:

  * radius selections as kNN + distance mask;
  * the VU decomposition and Martin's feature decomposition;
  * MD features (eigenvalue-threshold classes of the MD voting tensor);
  * ``preprocess_pointcloud``: estimate normals on the clean cloud,
    corrupt it, re-estimate and orient on the noisy cloud;
  * the symmetrised kNN graph with lumped masses, and r-ring
    neighbourhoods over a kNN graph.

The reference draws its noise from ``jax.random``; here the caller passes
the draws (``core.noise.draw_noise`` from an explicit ``torch.Generator``),
so the tests feed the reference's own.

The reference's scatters drop what falls outside the array (``mode="drop"``:
rows ``n`` of padding slots, ranks past ``cap``); here those entries are
masked out before the scatter, never wrapped or raised on.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import PatchConfig
from ..device import resolve_device
from ..ops import metrics
from ..ops.knn import knn
from ..ops.neighbors import Neighborhood
from . import noise as noise_mod
from . import voting
from .normals import orient_normals, pvt_normals
from .patches import md_selection, point_masses


def radius_neighborhood(points: torch.Tensor, radius, k_cap: int = 64,
                        num_valid: Optional[int] = None) -> Neighborhood:
    """All points within ``radius`` (scalar or per-point), capped at the
    k_cap nearest; points beyond the cap are dropped."""
    nbh, d = knn(points, k_cap, num_valid=num_valid)
    r = torch.as_tensor(radius, dtype=points.dtype, device=points.device)
    r2 = torch.broadcast_to(r**2, (points.shape[0],))
    return nbh.and_mask(d <= r2[:, None])


def vu_decomposition(points: torch.Tensor, normals: torch.Tensor, k_cap: int = 64):
    """Radius selection at r = 2 * mean 6-NN edge length,
    NormalFilteredNVT(rho=0.95) -> VU-smoothed normals (tau=0.3, d=3) ->
    NormalFilteredPVT."""
    nbh6, _ = knn(points, 6, exclude_self=True)
    r = 2.0 * metrics.average_edge_length(points, nbh6)
    sel = radius_neighborhood(points, r, k_cap)
    nvt = voting.normal_filtered_nvt(sel, normals, rho=0.95)
    filtered = voting.vu_smoothed_normals(nvt, normals, tau=0.3, damping=3.0)
    return voting.normal_filtered_pvt(points, sel, filtered, rho=0.95)


def martin_feature_decomposition(points: torch.Tensor, normals: torch.Tensor, r,
                                 rho: float = 0.9, k_cap: int = 64):
    """Returns (decomposition, VU-smoothed normals)."""
    sel = radius_neighborhood(points, r, k_cap)
    nvt = voting.normal_filtered_nvt(sel, normals, rho)
    filtered = voting.vu_smoothed_normals(nvt, normals)
    return voting.normal_filtered_pvt(points, sel, filtered, rho), filtered


def md_features(points: torch.Tensor, normals: torch.Tensor,
                cfg: PatchConfig = PatchConfig()) -> torch.Tensor:
    """MD-selection voting tensor -> classes {0: none, 1: flat, 2: edge,
    3: corner}."""
    nbh, mass, _ = md_selection(points, cfg)
    dec, _ = voting.md_transformation(points, nbh, normals, mass)
    return voting.md_features(dec)


def preprocess_pointcloud(draws, points: torch.Tensor, k: int = 12,
                          noise_level: float = 0.3, device=None):
    """Estimate normals on the clean cloud, corrupt it along them (stdev =
    noise_level * mean edge length), then re-estimate and orient normals on
    the noisy cloud. ``draws`` are ``core.noise.draw_noise(n, generator)``'s,
    where the reference takes a ``jax.random`` key.

    Returns (noisy_points, noisy_normals, gt_normals)."""
    dev = resolve_device(device)
    points = torch.as_tensor(points, dtype=torch.float32).to(dev)
    nbh, _ = knn(points, k, exclude_self=True)
    gt_n = pvt_normals(points, nbh)  # not oriented
    mel = metrics.average_edge_length(points, nbh)
    noisy = noise_mod.apply_noise(points, gt_n, draws[0], draws[1], noise_level, mel)
    nbh2, _ = knn(noisy, k, exclude_self=True)
    noisy_n = orient_normals(noisy, pvt_normals(noisy, nbh2), nbh2)
    return noisy, noisy_n, gt_n


def _scatter_rows(shape, rows, cols, values, keep, fill):
    """out[rows, cols] = values where keep, on an array of ``fill``."""
    out = torch.full(shape, fill, dtype=values.dtype, device=values.device)
    out[rows[keep], cols[keep]] = values[keep]
    return out


def laplacian_neighborhood(points: torch.Tensor, k: int = 12, cap: Optional[int] = None):
    """Union-symmetrised kNN graph (j ~ i iff j in kNN(i) or i in kNN(j))
    with the lumped masses pi r_k^2 / k; reverse edges past ``cap``
    (default 2k) slots a point are dropped.

    Returns (Neighborhood (N, cap), mass (N,))."""
    if cap is None:
        cap = 2 * k
    n = points.shape[0]
    dev = points.device
    nbh, dists = knn(points, k, exclude_self=True)
    # Reverse edges: group the flat (src -> tgt) list by target, then slot
    # each source at its rank within the group.
    flat_t = torch.where(nbh.mask, nbh.idx, n).reshape(-1)
    flat_s = torch.arange(n, device=dev)[:, None].expand(n, k).reshape(-1)
    order = torch.argsort(flat_t, stable=True)
    st, ss = flat_t[order], flat_s[order]
    rank = torch.arange(n * k, device=dev) - torch.searchsorted(st, st, side="left")
    keep = (st < n) & (rank < cap)
    rev_idx = _scatter_rows((n, cap), st, rank, ss, keep, 0)
    rev_mask = _scatter_rows((n, cap), st, rank, torch.ones_like(keep), keep, False)
    # Union forward + reverse, deduplicated by sorting.
    both = torch.cat([torch.where(nbh.mask, nbh.idx, n), torch.where(rev_mask, rev_idx, n)],
                     dim=1)
    sorted_ids = torch.sort(both, dim=1).values
    first = torch.cat([torch.ones((n, 1), dtype=torch.bool, device=dev),
                       sorted_ids[:, 1:] != sorted_ids[:, :-1]], dim=1) & (sorted_ids < n)
    slot = torch.cumsum(first, dim=1) - 1
    rows = torch.arange(n, device=dev)[:, None].expand_as(slot)
    keep = first & (slot < cap)
    out_idx = _scatter_rows((n, cap), rows, slot, sorted_ids, keep, 0)
    out_mask = _scatter_rows((n, cap), rows, slot, first, keep, False)
    return Neighborhood(idx=out_idx, mask=out_mask), point_masses(dists, k)


def k_ring(nbh: Neighborhood, rings: int, cap: int = 64) -> Neighborhood:
    """r-ring neighbourhoods over the kNN graph: ring r+1's candidates are
    the neighbours of ring r's members, deduplicated into ``cap`` slots.
    Exact while the true ring size stays within ``cap``. (The reference
    sends every entry it does not keep to an extra column that it then
    discards; here those entries are not written.)"""
    n, k = nbh.idx.shape
    dev = nbh.idx.device
    idx = torch.where(nbh.mask, nbh.idx, torch.arange(n, device=dev)[:, None])
    cur_idx, cur_mask = idx, nbh.mask
    rows = torch.arange(n, device=dev)[:, None]
    for _ in range(rings - 1):
        cand = idx[cur_idx].reshape(n, -1)
        cand_mask = (nbh.mask[cur_idx] & cur_mask[..., None]).reshape(n, -1)
        key = torch.where(torch.cat([cur_mask, cand_mask], dim=1),
                          torch.cat([cur_idx, cand], dim=1), n)
        sorted_ids = torch.sort(key, dim=1).values
        first = torch.cat([torch.ones((n, 1), dtype=torch.bool, device=dev),
                           sorted_ids[:, 1:] != sorted_ids[:, :-1]], dim=1) & (sorted_ids < n)
        rank = torch.cumsum(first, dim=1) - 1
        keep = first & (rank < cap)
        r = rows.expand_as(rank)
        cur_idx = _scatter_rows((n, cap), r, rank, sorted_ids, keep, 0)
        cur_mask = _scatter_rows((n, cap), r, rank, first, keep, False)
    return Neighborhood(idx=torch.where(cur_mask, cur_idx, 0), mask=cur_mask)
