"""Beyond-one-card windowed denoise (torch), as ``ngpd_tpu/parallel/halo.py``:
halo windows, no replication.

``parallel/fused_sharded.py`` all-gathers the whole sorted cloud onto every
rank each pass round. This module keeps each rank at O(N / d + window)
rows:

- **Distributed Morton sort** (``morton_sort_sharded``): each rank sorts
  its rows, then d odd-even merge-split phases between ring neighbours
  give the globally sorted order (the 0-1 principle makes d phases enough
  for locally sorted blocks). The order is the total order on (code, gid),
  so it equals ``ops/morton.py::morton_sort`` row for row.
- **Halo iterations** (``fused_denoise_halo``): a tile's window reaches at
  most ``window`` rows past the rank's rows, so each rank needs a
  ``window``-row halo from each neighbour: paired point-to-point sends of
  (window, 3) an array, and no all-gather (``COLLECTIVES["all_gather"]``
  stays 0).

Window semantics are those of ``fused_denoise_sharded`` (the same loop,
``fused_sharded.windowed_iterations``), so the results match it row for
row. Outputs stay in sorted order with each row's original index: the
unsort is a global permutation, which a caller at this scale does at
ingest or egress, not per call.

The reference pads the whole array to a multiple of ranks x tile, which
in ``torch.distributed`` would move rows between ranks. Here each rank pads
its own rows to the same per-rank count, and the padding rows take the
original indices that the whole array's padding would have, so the
sorted cloud (padding sorts to the tail in index order) is the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..collectives import all_reduce, exchange
from ..config import DenoiseConfig
from ..core.fused import _Tiles
from ..core.pipeline import DEFAULT_STRATEGY
from ..device import exact_float32
from ..ops.morton import codes_in_box, valid_bounds
from .fused_sharded import TILES_A_BATCH, check_engine_args, windowed_iterations
from .mesh import POINTS_AXIS, mesh_axis


class ShardedSortedCloud(NamedTuple):
    """This rank's rows of the Morton-sorted cloud: rank i holds the global
    sorted rows [i * rows, (i + 1) * rows); padding rows sort to the tail."""

    pos: torch.Tensor  # (rows, 3)
    nrm: torch.Tensor  # (rows, 3)
    orig_idx: torch.Tensor  # (rows,) int64: sorted row -> original row
    num_valid: int


def _ring_perms(d: int):
    """(to_right, to_left) (source, destination) pairs of a d-rank line."""
    return (
        [(i, i + 1) for i in range(d - 1)],
        [(i + 1, i) for i in range(d - 1)],
    )


def _halo_exchange(arr: torch.Tensor, window: int, group, d: int, rank: int) -> torch.Tensor:
    """(rows, c) -> (window + rows + window, c): ``window`` rows from each
    line neighbour. End ranks get zeros in their outer halo, never read
    there, because the global window clip keeps the first and last rank's
    tiles inside their own rows."""
    left = arr.new_zeros((window,) + tuple(arr.shape[1:]))
    right = torch.zeros_like(left)
    sends, recvs = [], []
    for src, dst in _ring_perms(d)[0]:
        if src == rank:
            sends.append((arr[-window:].contiguous(), dst))
        if dst == rank:
            recvs.append((left, src))
    for src, dst in _ring_perms(d)[1]:
        if src == rank:
            sends.append((arr[:window].contiguous(), dst))
        if dst == rank:
            recvs.append((right, src))
    exchange(sends, recvs, group)
    return torch.cat([left, arr, right])


def _local_morton_codes(pos, valid, group) -> torch.Tensor:
    """Morton codes with GLOBAL quantisation bounds (an all-reduce MIN and
    MAX: the bounds the single-device sort takes from the whole array)."""
    safe, mn, mx = valid_bounds(pos, valid)
    return codes_in_box(safe, valid, all_reduce(mn, "min", group), all_reduce(mx, "max", group))


def _sort8(key, payload):
    """Sort rows by key, carrying the (rows, 6) positions and normals. The
    key ``code << 32 | gid`` (both non-negative, the padding code 2**30) is
    the total order on (code, gid), so the merge-split network and one
    whole sort agree exactly, duplicate codes included."""
    key, order = torch.sort(key)
    return key, payload[order]


def _sort_body(pts_l, nrm_l, gid, nv: int, group, d: int, rank: int):
    """This rank's rows of the globally Morton-sorted cloud: a local sort,
    then d odd-even merge-split phases between neighbours. ``gid`` is each
    row's original index. Returns (positions, normals, original indices)."""
    rows = pts_l.shape[0]
    valid = gid < nv
    # Padding coordinates go to a finite far corner (ops/morton.py).
    ninf = torch.full_like(pts_l, -torch.inf)
    far = all_reduce(torch.where(valid[:, None], pts_l, ninf).amax(dim=0), "max", group) + 1.0
    pts_l = torch.where(valid[:, None], pts_l, far)
    code = _local_morton_codes(pts_l, valid, group)
    key, payload = _sort8((code.to(torch.int64) << 32) | gid, torch.cat([pts_l, nrm_l], 1))

    for phase in range(d):
        # Even phases pair (0, 1) (2, 3) ...; odd phases (1, 2) (3, 4) ...;
        # a rank without a partner keeps its rows.
        pairs = [(i, i + 1) for i in range(phase % 2, d - 1, 2)]
        partner = next((b if a == rank else a for a, b in pairs if rank in (a, b)), None)
        if partner is None:
            continue
        r_key, r_payload = torch.empty_like(key), torch.empty_like(payload)
        exchange([(key, partner), (payload, partner)], [(r_key, partner), (r_payload, partner)],
                 group)
        m_key, m_payload = _sort8(torch.cat([key, r_key]), torch.cat([payload, r_payload]))
        keep = slice(0, rows) if rank < partner else slice(rows, 2 * rows)
        key, payload = m_key[keep], m_payload[keep]
    return payload[:, :3], payload[:, 3:], key & 0xFFFFFFFF


def morton_sort_sharded(points, normals, mesh: DeviceMesh, num_valid: Optional[int] = None,
                        axis: str = POINTS_AXIS, device=None) -> ShardedSortedCloud:
    """Distributed Morton sort of this rank's rows, O(N / d) rows a rank.
    Every rank holds the same count of rows; padding rows (>= num_valid)
    sit at the end in original order."""
    group, d, rank = mesh_axis(mesh, axis, device)
    pts = torch.as_tensor(points, dtype=torch.float32).to(mesh.device_type)
    nrm = torch.as_tensor(normals, dtype=torch.float32).to(mesh.device_type)
    rows = pts.shape[0]
    nv = rows * d if num_valid is None else int(num_valid)
    gid = rank * rows + torch.arange(rows, device=pts.device)
    pos, nrm_s, orig = _sort_body(pts, nrm, gid, nv, group, d, rank)
    return ShardedSortedCloud(pos=pos, nrm=nrm_s, orig_idx=orig, num_valid=nv)


def fused_denoise_halo(
    points,
    normals,
    mesh: DeviceMesh,
    cfg: DenoiseConfig = DenoiseConfig(),
    strategy: tuple[str, str, str] = DEFAULT_STRATEGY,
    iterations: Optional[int] = None,
    num_valid: Optional[int] = None,
    tile: int = 256,
    window: int = 256,
    threshold_method: str = "exact",
    threshold_slack: float = 1.05,
    axis: str = POINTS_AXIS,
    device=None,
):
    """Windowed denoise with O(N / d + window) rows a rank.

    ``points`` / ``normals``: this rank's rows of the row-sharded cloud.
    Returns this rank's (positions, normals, classes, orig_idx) in SORTED
    order: rank i holds the sorted rows [i * rows, (i + 1) * rows) that lie
    below the input's row count. Valid rows are the first ``num_valid``
    sorted rows; ``orig_idx`` maps each row to its original row.

    Requires window <= rows a rank after the padding to ranks x tile."""
    pg, d, rank = mesh_axis(mesh, axis, device)
    iters = cfg.iterations if iterations is None else iterations
    check_engine_args(iters, threshold_method)
    exact_float32()
    pts = torch.as_tensor(points, dtype=torch.float32).to(mesh.device_type)
    nrm = torch.as_tensor(normals, dtype=torch.float32).to(mesh.device_type)
    rows_in = pts.shape[0]
    n_in = rows_in * d
    nv = n_in if num_valid is None else int(num_valid)
    n = -(-n_in // (d * tile)) * d * tile
    rows = n // d
    if window > rows:
        raise ValueError(
            f"window ({window}) must not exceed rows per shard ({rows}): "
            "the halo reaches one ring neighbor only"
        )
    dev = pts.device
    i = torch.arange(rows, device=dev)
    gid = torch.where(i < rows_in, rank * rows_in + i, n_in + rank * (rows - rows_in) + i - rows_in)
    if rows != rows_in:
        pad = torch.zeros((rows - rows_in, 3), dtype=torch.float32, device=dev)
        pts, nrm = torch.cat([pts, pad]), torch.cat([nrm, pad])
    pos0, nrm0, gid = _sort_body(pts, nrm, gid, nv, pg, d, rank)

    lo = rank * rows  # first global sorted row of this rank
    geo = _Tiles(n, nv, tile, window, TILES_A_BATCH, dev, first=lo // tile,
                 count=rows // tile, origin=lo - window, length=rows + 2 * window)
    pos, nrm_f, cls = windowed_iterations(
        pos0, nrm0, lo, geo, lambda a: _halo_exchange(a, window, pg, d, rank), pg, cfg,
        strategy, iters, threshold_slack)
    keep = max(0, min(rows, n_in - lo))
    return pos[:keep], nrm_f[:keep], cls[:keep], gid[:keep]
