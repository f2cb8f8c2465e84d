"""Point-axis-sharded geometry (torch), as ``ngpd_tpu/parallel/sharded.py``:
kNN, Chamfer and the dense denoise loop.

Each rank holds its own query rows of the row-sharded cloud; the whole
coordinate set is all-gathered and every rank runs the single-device
dense ``(rows, k)`` functions on its rows. Cross-rank reductions (the mean
edge length, the per-class flat delta) are all-reduces. Functions take
and return this rank's rows (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..collectives import all_gather, all_reduce
from ..config import DenoiseConfig
from ..core.pipeline import DEFAULT_STRATEGY, denoise_iteration
from ..device import exact_float32
from ..ops.knn import knn, nn_distances
from ..ops.neighbors import Neighborhood
from .mesh import POINTS_AXIS, mesh_axis


def _local(x, mesh: DeviceMesh) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(mesh.device_type)


def knn_sharded(points, k: int, mesh: DeviceMesh, axis: str = POINTS_AXIS,
                exclude_self: bool = False, num_valid: Optional[int] = None, device=None):
    """kNN of this rank's query rows against the whole cloud.

    Returns (Neighborhood, sqdists) of this rank's rows with GLOBAL indices.
    Rows at or past ``num_valid`` are no neighbours of anyone; with
    ``exclude_self`` a query's own row (by the rank's global row offset)
    is dropped from its neighbours."""
    group, _, rank = mesh_axis(mesh, axis, device)
    local = _local(points, mesh)
    rows = local.shape[0]
    full = all_gather(local, group)
    nv = full.shape[0] if num_valid is None else int(num_valid)
    if not exclude_self:
        return knn(full, k, local, num_valid=nv)
    nbh, d = knn(full, k + 1, local, num_valid=nv)
    grow = rank * rows + torch.arange(rows, device=local.device)
    is_self = nbh.idx == grow[:, None]
    # Drop the self column: a stable sort puts it last.
    order = torch.sort(torch.where(is_self, torch.inf, d), dim=1, stable=True).indices[:, :k]
    mask = torch.gather(nbh.mask & ~is_self, 1, order)
    return (Neighborhood(idx=torch.gather(nbh.idx, 1, order), mask=mask),
            torch.gather(d, 1, order))


def chamfer_distance_sharded(pos0, pos1, mesh: DeviceMesh, axis: str = POINTS_AXIS,
                             device=None) -> torch.Tensor:
    """Bi-directional mean squared NN distance of two row-sharded clouds:
    a scalar, the same on every rank. Padding rows count as points, as in
    the reference."""
    group, d, _ = mesh_axis(mesh, axis, device)
    a, b = _local(pos0, mesh), _local(pos1, mesh)
    fa, fb = all_gather(a, group), all_gather(b, group)
    d0, _ = nn_distances(a, fb)
    d1, _ = nn_distances(b, fa)
    total = all_reduce(torch.sum(d0) + torch.sum(d1), "sum", group)
    return total / ((a.shape[0] + b.shape[0]) * d)


def denoise_sharded(points, normals, mesh: DeviceMesh, cfg: DenoiseConfig = DenoiseConfig(),
                    strategy: tuple[str, str, str] = DEFAULT_STRATEGY,
                    iterations: Optional[int] = None, num_valid: Optional[int] = None,
                    axis: str = POINTS_AXIS, device=None):
    """The classical denoise with this rank's rows: one all-gather of
    positions and one of normals an iteration, one of the smoothed normals
    inside it, everything else local. The d threshold and the flat-step
    delta reduce across the ranks, so the result is the single-device
    one. Returns (points, normals) of this rank's rows."""
    group, _, _ = mesh_axis(mesh, axis, device)
    exact_float32()
    iters = cfg.iterations if iterations is None else iterations
    pos, nrm = _local(points, mesh), _local(normals, mesh)

    def gather(x):
        return all_gather(x, group)

    # d = d_scale * mean 6-NN edge length over every rank's rows (the self
    # edge included, as the single-device step_threshold).
    full0 = gather(pos)
    nv = full0.shape[0] if num_valid is None else int(num_valid)
    nbh6, d6 = knn(full0, 6, pos, num_valid=nv)
    dist = torch.sqrt(torch.where(nbh6.mask, d6, 0.0))
    sums = all_reduce(torch.stack([torch.sum(dist), torch.sum(nbh6.mask).to(dist.dtype)]),
                      "sum", group)
    d_thr = cfg.d_scale * sums[0] / torch.clamp(sums[1], min=1.0)

    for _ in range(iters):
        src_pos, src_nrm = gather(pos), gather(nrm)
        nbh_f, _ = knn(src_pos, cfg.feature_k, pos, num_valid=nv)
        nbh_s, _ = knn(src_pos, cfg.step_k, pos, num_valid=nv)
        pos, nrm, _ = denoise_iteration(
            pos, nrm, nbh_f, nbh_s, d_thr, cfg.alphas, cfg.angle, cfg.class_scale, strategy,
            cfg.vu_tau, cfg.vu_damping, src_points=src_pos, src_normals=src_nrm,
            gather_fn=gather, axis_name=group)
    return pos, nrm
