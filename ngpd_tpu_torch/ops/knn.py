"""k-nearest-neighbour search (torch), as ``ngpd_tpu/ops/knn.py``.

``knn`` is the exact brute-force search. On CUDA tensors it is one
search launch of the hand-written kernel ``kernels/csrc/knn.cu``
(``kernels/knn.py``), which skips the point tiles no query can reach,
beside the launches that box the tiles or cap the queries and the merge
where the queries are too few to fill the card; on CPU tensors it runs its
plain version, ``knn_plain``: query chunks against point tiles with a
running top-k, so
one ``(query_tile, point_tile)`` distance block is live at a time. The
two return the same bits. ``knn_grid`` is the voxel-hash search for large
clouds: each query scans the 27 cells around it. ``nn_distances`` (the
primitive behind the Chamfer-family metrics) is ``knn`` with k = 1.

Squared distances are float32 ``|q|^2 + |p|^2 - 2 q.p`` clamped at 0; the
contraction has length 3 and is written out, so no matrix product (and no
TF32) is involved and the CPU and the card round alike.

Ties. ``jax.lax.top_k`` keeps the lower position among equal values;
``torch.topk`` promises no order. The selection here is made on an int64
key, the distance's bit pattern (monotone for non-negative floats) above
the candidate's position, so equal distances resolve to the lower
position as in the reference, on every device, run after run.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import knn as _card
from .neighbors import Neighborhood

_INF = float("inf")
# Hash primes for voxel-grid cells (standard spatial-hash constants).
_P1, _P2, _P3 = 73856093, 19349663, 83492791


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (Qa, 3) x (Qb, 3) -> (Qa, Qb), as
    |a|^2 + |b|^2 - 2 a.b, clamped at 0 against cancellation."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    aa = (a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1] + a[:, 2] * a[:, 2])[:, None]
    bb = (b[:, 0] * b[:, 0] + b[:, 1] * b[:, 1] + b[:, 2] * b[:, 2])[None, :]
    ab = (a[:, 0:1] * b[:, 0][None, :] + a[:, 1:2] * b[:, 1][None, :]
          + a[:, 2:3] * b[:, 2][None, :])
    return torch.clamp(aa + bb - 2.0 * ab, min=0.0)


def _topk_smallest(d: torch.Tensor, idx: torch.Tensor, k: int):
    """Row-wise k smallest of d (non-negative, inf allowed) with their
    idx, ascending, equal values in order of position. d, idx: (Q, M)."""
    if k == 1:
        # torch.min returns the first minimal value's index.
        vals, pos = torch.min(d, dim=1, keepdim=True)
        return vals, torch.gather(idx, 1, pos)
    if d.dtype == torch.float64:
        # No room for the position beside 64 key bits: a stable sort keeps
        # equal values in order of position.
        pos = torch.sort(d, dim=1, stable=True).indices[:, :k]
        return torch.gather(d, 1, pos), torch.gather(idx, 1, pos)
    m = d.shape[1]
    bits = (d + 0.0).contiguous().view(torch.int32).to(torch.int64)  # -0.0 -> +0.0
    key = (bits << 32) | torch.arange(m, dtype=torch.int64, device=d.device)[None, :]
    pos = torch.topk(key, k, dim=1, largest=False, sorted=True).values & 0xFFFFFFFF
    return torch.gather(d, 1, pos), torch.gather(idx, 1, pos)


def _knn_chunk(q_chunk, points, k: int, point_tile: int, num_valid: int, exclude_idx):
    """Exact kNN of one query chunk against all points: scan the point
    tiles, keeping a running (Qc, k) best set; each step selects from the
    running set followed by the fresh tile."""
    qc = q_chunk.shape[0]
    dev = points.device
    best_d = torch.full((qc, k), _INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((qc, k), dtype=torch.int64, device=dev)
    for p0 in range(0, points.shape[0], point_tile):
        blk = points[p0 : p0 + point_tile]
        d = pairwise_sqdist(q_chunk, blk)
        gidx = p0 + torch.arange(blk.shape[0], dtype=torch.int64, device=dev)[None, :]
        d = torch.where(gidx >= num_valid, _INF, d)
        if exclude_idx is not None:
            d = torch.where(gidx == exclude_idx[:, None], _INF, d)
        all_d = torch.cat([best_d, d], dim=1)
        all_i = torch.cat([best_i, gidx.expand(qc, -1)], dim=1)
        best_d, best_i = _topk_smallest(all_d, all_i, k)
    return best_d, best_i


def _finish(d, i):
    mask = torch.isfinite(d)
    idx = torch.where(mask, i, 0)
    return Neighborhood(idx=idx, mask=mask), torch.where(mask, d, _INF)


def _operands(points, queries, exclude_self: bool):
    if exclude_self and queries is not None:
        raise ValueError("exclude_self requires queries drawn from `points`")
    points = torch.as_tensor(points, dtype=torch.float32).contiguous()
    q = points if queries is None else torch.as_tensor(
        queries, dtype=torch.float32).to(points.device).contiguous()
    return points, q


def knn_plain(
    points: torch.Tensor,
    k: int,
    queries: Optional[torch.Tensor] = None,
    *,
    exclude_self: bool = False,
    num_valid: Optional[int] = None,
    point_tile: int = 2048,
    query_tile: int = 1024,
):
    """``knn``'s plain version on any device: the tile loop, one
    ``(query_tile, point_tile)`` block at a time. ``knn`` runs it on CPU
    tensors; the tests and ``chip_smoke.py`` hold the kernel to it."""
    points, q = _operands(points, queries, exclude_self)
    n, nq = points.shape[0], q.shape[0]
    nv = n if num_valid is None else int(num_valid)
    ds, idxs = [], []
    for q0 in range(0, nq, query_tile):
        qc = q[q0 : q0 + query_tile]
        ex = (q0 + torch.arange(qc.shape[0], dtype=torch.int64, device=points.device)
              if exclude_self else None)
        d, i = _knn_chunk(qc, points, k, point_tile, nv, ex)
        ds.append(d)
        idxs.append(i)
    return _finish(torch.cat(ds), torch.cat(idxs))


def knn(
    points: torch.Tensor,
    k: int,
    queries: Optional[torch.Tensor] = None,
    *,
    exclude_self: bool = False,
    num_valid: Optional[int] = None,
    point_tile: int = 2048,
    query_tile: int = 1024,
):
    """Exact brute-force kNN: for each query, the k nearest of ``points``.

    Returns ``(Neighborhood, sqdists)`` with ascending distances per row,
    on ``points``' device. With ``exclude_self=False`` a query drawn from
    ``points`` is its own first neighbour (scipy ``KDTree.query``
    semantics); with ``exclude_self=True`` (requires ``queries is None``)
    the self match is masked. Rows of ``points`` at or past ``num_valid``
    are ignored; slots that found no neighbour are masked out. Equal
    distances keep the lower index.

    On CUDA tensors ``kernels/csrc/knn.cu`` computes it, for every k, in
    one search launch after one that boxes the tiles (after one that caps
    the queries and before a merge where it splits the points); ``point_tile`` and
    ``query_tile`` are the plain
    version's tiles (``knn_plain``, which CPU tensors run) and the kernel
    ignores them. Any other device raises.
    """
    points, q = _operands(points, queries, exclude_self)
    if not _card._check(points, q):
        return knn_plain(points, k, None if queries is None else q,
                         exclude_self=exclude_self,
                         num_valid=num_valid, point_tile=point_tile,
                         query_tile=query_tile)
    nv = points.shape[0] if num_valid is None else int(num_valid)
    return _finish(*_card.search(points, q, k, nv, exclude_self))


def nn_distances(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    num_valid_b: Optional[int] = None,
    query_tile: int = 2048,
    point_tile: int = 16384,
):
    """1-NN squared distance from each point of ``a`` into cloud ``b``.

    Returns ``(sqdist (Qa,), idx (Qa,) int64)`` on ``a``'s device; rows
    of ``b`` at or past ``num_valid_b`` are ignored. ``knn`` with k = 1:
    the kernel on CUDA tensors, the tiles only on the CPU.
    """
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32).to(a.device)
    nbh, d = knn(b, 1, a, num_valid=num_valid_b, point_tile=point_tile,
                 query_tile=query_tile)
    return d[:, 0], nbh.idx[:, 0]


def _cell_hash(cells: torch.Tensor, table_bits: int) -> torch.Tensor:
    """Spatial hash of integer cell coordinates -> [0, 2^table_bits).

    The reference multiplies int32 cells by the primes and lets the
    product wrap; only the low ``table_bits`` (< 32) bits survive the
    mask, and those are the same in a wrapped int32 product and in the
    int64 product taken here (two's complement, negative cells too)."""
    c = cells.to(torch.int64)
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return h & ((1 << table_bits) - 1)


def knn_grid(
    points: torch.Tensor,
    k: int,
    cell_size,
    queries: Optional[torch.Tensor] = None,
    *,
    capacity: int = 64,
    exclude_self: bool = False,
    num_valid: Optional[int] = None,
    query_tile: int = 4096,
    table_bits: Optional[int] = None,
):
    """Voxel-hash kNN for large clouds.

    Points are bucketed into cubic cells of edge ``cell_size`` and sorted
    by cell hash; each query scans the 27 surrounding cells, up to
    ``capacity`` points per hash run. Exact whenever the true k-th
    neighbour lies within ``cell_size`` and no visited hash run overflows
    ``capacity``. Returns ``(Neighborhood, sqdists)`` as ``knn``.
    """
    self_query = queries is None
    if exclude_self and not self_query:
        raise ValueError("exclude_self requires queries drawn from `points`")
    points = torch.as_tensor(points, dtype=torch.float32)
    dev = points.device
    q = points if self_query else torch.as_tensor(queries, dtype=torch.float32).to(dev)
    n, nq = points.shape[0], q.shape[0]
    nv = n if num_valid is None else int(num_valid)
    if table_bits is None:
        table_bits = max(10, math.ceil(math.log2(max(2 * n, 2))))

    cell_size = torch.as_tensor(cell_size, dtype=torch.float32, device=dev)
    origin = torch.min(torch.where(torch.isfinite(points), points, 0.0)) - 1.0

    def cells_of(x):
        return torch.floor((x - origin) / cell_size).to(torch.int64)

    pidx = torch.arange(n, dtype=torch.int64, device=dev)
    ph = _cell_hash(cells_of(points), table_bits)
    # Padding rows take the largest hash so they sort to the end.
    ph = torch.where(pidx < nv, ph, (1 << table_bits) - 1)
    order = torch.argsort(ph, stable=True)
    ph_sorted = ph[order].contiguous()

    r = torch.arange(-1, 2, dtype=torch.int64, device=dev)
    off = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(27, 3)
    cap_iota = torch.arange(capacity, dtype=torch.int64, device=dev)

    ds, idxs = [], []
    for q0 in range(0, nq, query_tile):
        qc = q[q0 : q0 + query_tile]
        t = qc.shape[0]
        nh = _cell_hash(cells_of(qc)[:, None, :] + off[None, :, :], table_bits)  # (T, 27)
        starts = torch.searchsorted(ph_sorted, nh.contiguous(), side="left")
        pos = starts[..., None] + cap_iota  # (T, 27, C) positions in sorted order
        pos_c = torch.clamp(pos, max=n - 1)
        run_ok = (pos < n) & (ph_sorted[pos_c] == nh[..., None])
        cand = order[pos_c].reshape(t, 27 * capacity)  # global point ids
        valid = run_ok.reshape(t, 27 * capacity) & (cand < nv)
        d = torch.zeros(cand.shape, dtype=torch.float32, device=dev)
        for c in range(3):
            diff = points[:, c][cand] - qc[:, c][:, None]
            d = d + diff * diff
        d = torch.where(valid, d, _INF)
        if exclude_self:
            ex = q0 + torch.arange(t, dtype=torch.int64, device=dev)
            d = torch.where(cand == ex[:, None], _INF, d)
        dk, ik = _topk_smallest(d, cand, k)
        ds.append(dk)
        idxs.append(ik)
    return _finish(torch.cat(ds), torch.cat(idxs))


def estimate_cell_size(points: torch.Tensor, k: int, sample: int = 1024,
                       safety: float = 1.25) -> torch.Tensor:
    """A grid cell size near the k-NN radius of a strided subsample of
    ``sample`` rows: the largest (k+1)-th neighbour distance, scaled by
    ``safety`` (k+1 covers the exclude_self case)."""
    points = torch.as_tensor(points, dtype=torch.float32)
    n = points.shape[0]
    stride = max(1, n // sample)
    sub = points[::stride][:sample]
    _, d = knn(points, k + 1, sub)
    return torch.max(torch.sqrt(d[:, -1])) * safety
