"""Sharded Morton-windowed denoise (torch), as
``ngpd_tpu/parallel/fused_sharded.py``: the windowed engine of
``core/fused.py`` with its tiles split over the ranks.

After a replicated Morton sort each rank owns a contiguous range of
sorted tiles. A tile's window reaches at most ``window`` rows past the
tile, and here each rank reads its windows from the whole sorted arrays,
all-gathered once a pass round, so no halo is needed and every rank runs
the single-device tile bodies on its tiles. The global scalars (the d
threshold, the per-class centres and spread deltas) are all-reduces.

The reference maps a shard's tiles one at a time (``lax.map``); here the
tiles go in batches of TILES_A_BATCH, as ``core/fused.py`` batches them (at
1M points a tile at a time would be 3,907 host-side steps a pass). The math
and the
global window clip ``starts = clip(t * tile - window, 0, n - wt)`` are the
reference's. Where the reference all-gathers a per-row operand that a rank
reads only at its own tiles' rows (thresholds, classes, edge directions),
the rank keeps its own rows: the values are the same. Per-tile partial
sums (the d threshold's, the class centres') are not summed per rank and
then across ranks: every rank takes all tiles' partials (an all-reduce of
a buffer that holds each tile's row on its own rank and zeros elsewhere,
which adds nothing but zeros) and sums them in tile order, as the
single-device engine does, so the result does not depend on the rank
count.

``windowed_iterations`` is the loop both this engine and the halo engine
(``parallel/halo.py``) run: they differ only in the arrays a window reads.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..collectives import all_gather, all_reduce
from ..config import DenoiseConfig
from ..core.fused import (THRESHOLD_METHODS, _dist_tile, _Tiles, classify_tile, smooth_tile,
                          spread_tile, threshold_tile, update_tile)
from ..core.pipeline import DEFAULT_STRATEGY
from ..device import exact_float32
from ..ops.morton import morton_sort, unsort
from .mesh import POINTS_AXIS, mesh_axis

TILES_A_BATCH = 64


def _all_tiles(parts: torch.Tensor, geo: _Tiles, group) -> torch.Tensor:
    """(num_tiles, ...) partials of every rank's tiles, from this rank's
    (count, ...) rows."""
    full = parts.new_zeros((geo.num_tiles,) + tuple(parts.shape[1:]))
    full[geo.t] = parts
    return all_reduce(full, "sum", group)


def windowed_iterations(pos, nrm, lo: int, geo: _Tiles, extend: Callable, group,
                        cfg: DenoiseConfig, strategy, iters: int, threshold_slack: float):
    """The windowed denoise of one rank's sorted rows ``[lo, lo + rows)``.

    ``geo`` maps this rank's tiles over the arrays that ``extend`` makes
    from a rank-local row array (the whole cloud, or the rows with a halo
    on each side). The stale thresholds are swept once on the input; each
    iteration runs passes A-D. Returns this rank's (positions, smoothed
    normals, classes)."""
    dev = pos.device
    nv = geo.nv
    cos_rho = torch.cos(torch.tensor(cfg.angle, dtype=torch.float32, device=dev))
    needs_delta = tuple(c for c in range(3) if strategy[c] in ("flat", "new"))

    def thr(t, col_valid, row_ok, tl, wn):
        return threshold_tile(tl[0], wn[0], col_valid, row_ok, cfg)

    rkf, rk8, sums, counts = geo.map(thr, extend(pos))
    rk_feat, rk_step = rkf.reshape(-1) * threshold_slack, rk8.reshape(-1) * threshold_slack
    d_thr = cfg.d_scale * torch.sum(_all_tiles(sums, geo, group)) / torch.clamp(
        torch.sum(_all_tiles(counts, geo, group)), min=1)
    pinned = (lo + torch.arange(pos.shape[0], device=dev)) >= nv

    nrm_ext, f_n, cls = extend(nrm), nrm, None
    for _ in range(iters):
        pos_ext = extend(pos)

        def pass_a(t, col_valid, row_ok, tl, wn):
            tp, tn, trk = tl
            d = _dist_tile(tp, wn[0], col_valid)
            return smooth_tile(tp, tn, wn[0], wn[1], d, trk, cos_rho, cfg)

        f_n = geo.map(pass_a, pos_ext, nrm_ext, rows=(rk_feat,)).reshape(-1, 3)
        f_n_ext = extend(f_n)

        def pass_b(t, col_valid, row_ok, tl, wn):
            tp, _, trk, trk8 = tl
            d = _dist_tile(tp, wn[0], col_valid)
            return classify_tile(tp, wn[0], wn[1], d, trk, trk8, row_ok, cos_rho, cfg,
                                 needs_delta)

        cls, edge, psums, pcnts = geo.map(pass_b, pos_ext, f_n_ext, rows=(rk_feat, rk_step))
        cls, edge = cls.reshape(-1), edge.reshape(-1, 3)

        deltas = {}
        if needs_delta:
            centers = torch.sum(_all_tiles(psums, geo, group), dim=0) / torch.clamp(
                torch.sum(_all_tiles(pcnts, geo, group), dim=0), min=1.0)[:, None]

            def pass_c(t, col_valid, row_ok, tl, wn):
                tp, tc, trk8 = tl
                d = _dist_tile(tp, wn[0], col_valid)
                return spread_tile(wn[0], d, tc, trk8, row_ok, centers, needs_delta)

            dmax = all_reduce(torch.amax(geo.map(pass_c, pos_ext, rows=(cls, rk_step)), dim=0),
                              "max", group)
            deltas = {c: dmax[ci] for ci, c in enumerate(needs_delta)}

        def pass_d(t, col_valid, row_ok, tl, wn):
            tp, tf, tc, te, trk8 = tl
            d = _dist_tile(tp, wn[0], col_valid)
            return update_tile(tp, tf, tc, te, wn[0], wn[1], d, trk8, cfg, strategy, d_thr,
                               deltas)

        new = geo.map(pass_d, pos_ext, f_n_ext, rows=(cls, edge, rk_step)).reshape(-1, 3)
        # Padding rows stay pinned.
        pos = torch.where(pinned[:, None], pos, new)
        nrm_ext = f_n_ext
    return pos, f_n, cls


def check_engine_args(iters: int, threshold_method: str) -> None:
    if iters < 1:
        raise ValueError("the windowed engines need at least one iteration")
    if threshold_method not in THRESHOLD_METHODS:
        raise ValueError(f"threshold_method must be one of {THRESHOLD_METHODS}, "
                         f"got {threshold_method!r}")


def fused_denoise_sharded(
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
    """Windowed denoise with the tiles split over the mesh axis.

    ``points`` / ``normals`` are this rank's (rows, 3) of the row-sharded
    cloud (every rank the same count). The whole cloud is padded to a
    multiple of ranks x tile. Returns this rank's rows of (points, normals,
    classes) in the original order, on the mesh's device."""
    pg, d, rank = mesh_axis(mesh, axis, device)
    iters = cfg.iterations if iterations is None else iterations
    check_engine_args(iters, threshold_method)
    exact_float32()
    pts_l = torch.as_tensor(points, dtype=torch.float32).to(mesh.device_type)
    nrm_l = torch.as_tensor(normals, dtype=torch.float32).to(mesh.device_type)
    rows_in = pts_l.shape[0]
    n_in = rows_in * d
    nv = n_in if num_valid is None else int(num_valid)

    # Replicate, pad and sort identically on every rank.
    full_p, full_n = all_gather(pts_l, pg), all_gather(nrm_l, pg)
    n = -(-n_in // (d * tile)) * d * tile
    if n != n_in:
        pad = torch.zeros((n - n_in, 3), dtype=torch.float32, device=full_p.device)
        full_p, full_n = torch.cat([full_p, pad]), torch.cat([full_n, pad])
    sc = morton_sort(full_p, full_n, nv)
    rows = n // d
    lo = rank * rows
    geo = _Tiles(n, nv, tile, window, TILES_A_BATCH, full_p.device, first=lo // tile,
                 count=rows // tile)
    pos, nrm, cls = windowed_iterations(
        sc.pos[lo : lo + rows], sc.nrm[lo : lo + rows], lo, geo, lambda a: all_gather(a, pg),
        pg, cfg, strategy, iters, threshold_slack)

    # Unsort the replicated result and keep this rank's input rows.
    mine = slice(rank * rows_in, (rank + 1) * rows_in)
    out_cls = all_gather(cls.to(torch.int32)[:, None], pg)
    return (unsort(all_gather(pos, pg), sc.orig_idx)[mine],
            unsort(all_gather(nrm, pg), sc.orig_idx)[mine],
            unsort(out_cls, sc.orig_idx)[mine, 0])
