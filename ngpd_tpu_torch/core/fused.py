"""Fused windowed denoise (torch), as ``ngpd_tpu/core/fused.py``: the
windowed rung of the accuracy ladder, and the engine the reference runs
off its accelerator (the CLI's >= 100k-point and ``--fused`` routes, and
each step of ``denoise_until_minimum_error_windowed(use_pallas=False)``).

Points are Morton-sorted once; each tile of ``tile`` sorted queries reads
one contiguous window of ``wt = tile + 2 * window`` sorted rows. kNN
becomes a (tile, wt) distance block and a per-row k-th-distance threshold,
and every neighbour reduction a masked (tile, wt) x (wt, C) product
against window columns. The math is the dense pipeline's; only the
neighbour sets are approximate (a point's k-th neighbour must lie in its
Morton window), and windows of at least the cloud size make them exact.

The reference maps its tiles in groups of ``group`` (``lax.map`` over
``vmap``) and its iterations with ``lax.scan``; here one Python loop runs
over the groups, each a batch of ``group`` tiles, and one over the
iterations. The reference has no Pallas kernel here, so plain torch
carries it. Every distance-like product runs in full float32
(``exact_float32``), as the reference's ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import DenoiseConfig
from ..device import exact_float32, resolve_device
from ..ops.eigh3 import eigh3x3
from ..ops.morton import morton_sort, unsort
from ..ops.solve3 import solve3x3_guarded
from . import voting
from .pipeline import DEFAULT_STRATEGY

_INF = float("inf")
THRESHOLD_METHODS = ("exact", "approx")


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of three, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm3(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot3(a, a))


def _dist_tile(tile_pos, win_pos, col_valid):
    """max(|a|^2 + |b|^2 - 2 a.b, 0) over (..., T, W), inf where the
    column is padding: one product for a.b, the reference's order."""
    aa = _dot3(tile_pos, tile_pos)[..., :, None]
    bb = _dot3(win_pos, win_pos)[..., None, :]
    ab = torch.matmul(tile_pos, win_pos.transpose(-1, -2))
    d = torch.clamp(aa + bb - 2.0 * ab, min=0.0)
    return torch.where(col_valid[..., None, :], d, _INF)


def _k_smallest(d: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest values of each row of d (non-negative, inf allowed),
    ascending, selected on ops/knn.py's int64 key (value bits above the
    position) so that equal values go in position order on every device."""
    w = d.shape[-1]
    bits = (d + 0.0).contiguous().view(torch.int32).to(torch.int64)  # -0.0 -> +0.0
    key = (bits << 32) | torch.arange(w, dtype=torch.int64, device=d.device)
    pos = torch.topk(key, k, dim=-1, largest=False, sorted=True).values & 0xFFFFFFFF
    return torch.gather(d, -1, pos)


def _kth_smallest(d: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row k-th smallest of d, for both threshold methods: the
    reference's "approx" is the TPU's approx_min_k, which selects exactly
    off the TPU."""
    return _k_smallest(d, k)[..., k - 1]


def _sym6(n: torch.Tensor) -> torch.Tensor:
    """(..., W, 3) -> (..., W, 6) upper-triangle columns of n n^T."""
    return torch.stack([n[..., 0] * n[..., 0], n[..., 0] * n[..., 1], n[..., 0] * n[..., 2],
                        n[..., 1] * n[..., 1], n[..., 1] * n[..., 2], n[..., 2] * n[..., 2]],
                       dim=-1)


def _mat3(s6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) symmetric."""
    a, b, c, d, e, f = (s6[..., i] for i in range(6))
    return torch.stack([torch.stack([a, b, c], -1), torch.stack([b, d, e], -1),
                        torch.stack([c, e, f], -1)], dim=-2)


def _nvt_tile(tile_pos, win_pos, win_n, d, mask_k, cos_rho):
    """better_filtered_nvt on a batch of tiles: keep the neighbours with
    |normalize(p_j - p_i) . n_j| < cos(rho), all of them in rows that keep
    none; the eigenpairs of the mean kept n_j n_j^T, as (G * T) rows."""
    pn_j = _dot3(win_pos, win_n)  # (G, W) p_j . n_j
    cross = torch.matmul(tile_pos, win_n.transpose(-1, -2))  # (G, T, W) p_i . n_j
    num = torch.abs(pn_j[..., None, :] - cross)
    cosang = num / torch.clamp(torch.sqrt(d), min=1e-12)
    w = (cosang < cos_rho) & mask_k
    wsum = torch.sum(w, dim=-1)
    w = torch.where((wsum == 0)[..., None], mask_k, w)
    wf = w.to(torch.float32)
    wsum = torch.sum(wf, dim=-1)
    t6 = torch.matmul(wf, _sym6(win_n)) / torch.clamp(wsum, min=1.0)[..., None]
    eigval, eigvec = eigh3x3(_mat3(t6))
    return voting.Decomposition(eigval.reshape(-1, 3), eigvec.reshape(-1, 3, 3))


def _clamp(vi, opt, alpha, d_thr):
    """vi + alpha (opt - vi) where that step is shorter than d_thr."""
    di = (opt - vi) * alpha
    return torch.where((_norm3(di) < d_thr)[..., None], vi + di, vi)


class _TileCtx(NamedTuple):
    tile_pos: torch.Tensor  # (G, T, 3)
    win_pos: torch.Tensor  # (G, W, 3)
    win_fn: torch.Tensor  # (G, W, 3) smoothed normals
    tile_fn: torch.Tensor  # (G, T, 3)
    d: torch.Tensor  # (G, T, W)
    mask8f: torch.Tensor  # (G, T, W) step-kNN membership as float32
    deg: torch.Tensor  # (G, T)


def _step_columns(ctx: _TileCtx):
    njvj = _dot3(ctx.win_fn, ctx.win_pos)  # (G, W)
    col_nnv = ctx.win_fn * njvj[..., None]  # (G, W, 3) n (n.p)
    m6 = _sym6(ctx.win_fn)
    s6 = torch.matmul(ctx.mask8f, m6)
    b_nv = torch.matmul(ctx.mask8f, col_nnv)
    sv = torch.matmul(ctx.mask8f, ctx.win_pos)
    return njvj, col_nnv, m6, s6, b_nv, sv


def _matvec(a, x):
    return torch.einsum("...ij,...j->...i", a, x)


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _flat_tile(ctx: _TileCtx, njvj, d_thr, alpha, delta):
    ninj = torch.matmul(ctx.tile_fn, ctx.win_fn.transpose(-1, -2))
    d2 = torch.clamp(delta * delta, min=1e-30)
    sim = torch.exp(-16.0 * (2.0 - 2.0 * ninj) / d2)
    close = torch.exp(-4.0 * torch.where(torch.isfinite(ctx.d), ctx.d, 0.0) / d2)
    wb = sim * close * ctx.mask8f
    dot = njvj[..., None, :] - torch.matmul(ctx.tile_pos, ctx.win_fn.transpose(-1, -2))
    num = torch.sum(wb * dot, dim=-1)
    wsum = torch.sum(wb, dim=-1)
    di = (num / torch.clamp(wsum, min=1e-30) * alpha)[..., None] * ctx.tile_fn
    nrm = _norm3(di)
    di = torch.where((nrm <= d_thr)[..., None], di, 0.0)
    return ctx.tile_pos + di


def _feature_like_tile(ctx: _TileCtx, s6, b_nv, sv, d_thr, alpha):
    """The feature system (Denoiser.py:144-162), with the raw count."""
    eye = torch.eye(3, dtype=torch.float32, device=s6.device)
    ni_o = _outer(ctx.tile_fn, ctx.tile_fn)
    a = eye + ni_o + _mat3(s6) + ctx.deg[..., None, None] * ni_o
    b = ctx.tile_pos + _matvec(ni_o, ctx.tile_pos) + _matvec(ni_o, sv) + b_nv
    opt, _ = solve3x3_guarded(a, b, ctx.tile_pos)
    return _clamp(ctx.tile_pos, opt, alpha, d_thr)


def _new_tile(ctx: _TileCtx, njvj, col_nnv, m6, d_thr, alpha, delta):
    dot = njvj[..., None, :] - torch.matmul(ctx.tile_pos, ctx.win_fn.transpose(-1, -2))
    d2 = torch.clamp(delta * delta, min=1e-30)
    like = torch.exp(-9.0 * (dot * dot) / d2) * ctx.mask8f
    # The cardinality stays the raw neighbour count (Denoiser.py:148,204).
    return _feature_like_tile(ctx, torch.matmul(like, m6), torch.matmul(like, col_nnv),
                              torch.matmul(like, ctx.win_pos), d_thr, alpha)


def _corner_tile(ctx: _TileCtx, s6, b_nv, d_thr, alpha):
    opt, _ = solve3x3_guarded(_mat3(s6), b_nv, ctx.tile_pos)
    return _clamp(ctx.tile_pos, opt, alpha, d_thr)


def _edge_tile(ctx: _TileCtx, s6, b_nv, d_thr, alpha, y):
    w, p = ctx.win_fn, ctx.win_pos
    # Q columns: n_c n_a p_b, 27 a window row.
    qcols = (w[..., :, None, None] * w[..., None, :, None] * p[..., None, None, :])
    q = torch.matmul(ctx.mask8f, qcols.reshape(*qcols.shape[:-3], 27))
    q = q.reshape(*q.shape[:-1], 3, 3, 3)  # (G, T, c, a, b)
    eye = torch.eye(3, dtype=torch.float32, device=s6.device)
    yy = _outer(y, y)
    proj = eye - yy
    a = (torch.einsum("...ij,...jk,...kl->...il", proj, _mat3(s6), proj)
         + ctx.deg[..., None, None] * yy)
    q_yy = torch.einsum("...cab,...a,...b->...c", q, y, y)
    yv = _dot3(y, ctx.tile_pos)
    b = _matvec(proj, b_nv - q_yy) + (ctx.deg * yv)[..., None] * y
    opt, _ = solve3x3_guarded(a, b, ctx.tile_pos)
    return _clamp(ctx.tile_pos, opt, alpha, d_thr)


class _Tiles:
    """The window geometry of one padded, sorted cloud of ``n`` rows, and the
    loop over groups of tiles (``tiles`` of the reference).

    Tiles ``[first, first + count)`` are mapped (all of them by default). The
    arrays the windows read hold the sorted rows ``[origin, origin +
    length)``: the whole cloud by default, or one rank's rows with a halo on
    each side (``parallel/halo.py``). A window that would leave them moves
    inside, as ``lax.dynamic_slice`` clamps its start, and a tile's rows are
    read from its window. Groups hold ``group`` tiles, the last one fewer."""

    def __init__(self, n: int, nv: int, tile: int, window: int, group: int, device,
                 first: int = 0, count: Optional[int] = None, origin: int = 0,
                 length: Optional[int] = None):
        self.n, self.nv, self.tile = n, nv, tile
        self.wt = min(tile + 2 * window, n)
        self.num_tiles = n // tile
        self.count = self.num_tiles - first if count is None else count
        self.g = max(1, min(group, self.count))
        self.t = torch.arange(first, first + self.count, device=device)
        starts = torch.clamp(self.t * tile - window, 0, n - self.wt)
        ws = torch.clamp(starts - origin, 0, (n if length is None else length) - self.wt)
        cols = torch.arange(self.wt, device=device)
        rows = torch.arange(tile, device=device)
        self.win = ws[:, None] + cols  # (count, W) rows of the arrays
        self.tile_rows = (ws + self.t * tile - starts)[:, None] + rows  # (count, T)
        self.col_valid = (starts[:, None] + cols) < nv
        self.row_ok = (self.t[:, None] * tile + rows) < nv

    def map(self, fn, *arrays, rows=()):
        """fn(t (G,) tile indices, col_valid (G, W), row_ok (G, T), tiles,
        windows) over every group of tiles. ``arrays`` give both tiles
        (G, T, ...) and windows (G, W, ...); ``rows`` hold one row per row
        of the mapped tiles, in order, and give tiles only, after those of
        ``arrays``. The outputs, each with a leading (G,) axis, are
        concatenated over the groups."""
        outs = []
        for g0 in range(0, self.count, self.g):
            sl = slice(g0, g0 + self.g)
            tl = [a[self.tile_rows[sl]] for a in arrays] + [
                r[g0 * self.tile : (g0 + self.g) * self.tile].reshape(-1, self.tile, *r.shape[1:])
                for r in rows]
            wn = [a[self.win[sl]] for a in arrays]
            out = fn(self.t[sl], self.col_valid[sl], self.row_ok[sl], tl, wn)
            outs.append(out if isinstance(out, tuple) else (out,))
        res = tuple(torch.cat(parts) for parts in zip(*outs))
        return res if len(res) > 1 else res[0]


def _masked(d, rk):
    """The kNN membership of a threshold: d <= rk per row, inf excluded."""
    return (d <= rk[..., None]) & (d < _INF)


def smooth_tile(tp, tn, wp, wn, d, rk, cos_rho, cfg: DenoiseConfig):
    """Pass A: NVT1 over the feature masks, then the VU-smoothed tile
    normals (G, T, 3)."""
    dec = _nvt_tile(tp, wp, wn, d, _masked(d, rk), cos_rho)
    f = voting.vu_smoothed_normals(dec, tn.reshape(-1, 3), cfg.vu_tau, cfg.vu_damping)
    return f.reshape(tp.shape)


def classify_tile(tp, wp, wf, d, rk, rk8, row_ok, cos_rho, cfg: DenoiseConfig, needs_delta):
    """Pass B: NVT2 -> classes (G, T), edge directions (G, T, 3), and per
    tile the delta classes' sums of p_j (G, C, 3) and counts (G, C) over
    the step masks."""
    dec = _nvt_tile(tp, wp, wf, d, _masked(d, rk), cos_rho)
    cls = voting.classes(dec, cfg.class_scale).reshape(tp.shape[:-1])
    edge_vec = dec.eigvec[..., 0].reshape(tp.shape)
    m8 = _masked(d, rk8).to(torch.float32)
    psums, pcnts = [], []
    for c in needs_delta:
        mc = m8 * ((cls == c) & row_ok).to(torch.float32)[..., None]
        psums.append(torch.sum(torch.matmul(mc, wp), dim=1))  # (G, 3)
        pcnts.append(torch.sum(mc, dim=(1, 2)))
    if needs_delta:
        return cls, edge_vec, torch.stack(psums, 1), torch.stack(pcnts, 1)
    g = tp.shape[0]
    return (cls, edge_vec, torch.zeros((g, 1, 3), device=tp.device),
            torch.zeros((g, 1), device=tp.device))


def spread_tile(wp, d, tc, rk8, row_ok, centers, needs_delta):
    """Pass C: per tile and delta class, the largest distance of a step
    neighbour from the class centre (G, C)."""
    m8 = _masked(d, rk8)
    outs = []
    for ci, c in enumerate(needs_delta):
        dist = _norm3(wp - centers[ci])  # (G, W)
        m = m8 & ((tc == c) & row_ok)[..., None]
        outs.append(torch.amax(torch.where(m, dist[:, None, :], 0.0), dim=(1, 2)))
    return torch.stack(outs, 1)


def update_tile(tp, tf, tc, te, wp, wf, d, rk8, cfg: DenoiseConfig, strategy, d_thr, deltas):
    """Pass D: the class-dispatched vertex updates of a batch of tiles."""
    m8f = _masked(d, rk8).to(torch.float32)
    ctx = _TileCtx(tile_pos=tp, win_pos=wp, win_fn=wf, tile_fn=tf, d=d,
                   mask8f=m8f, deg=torch.sum(m8f, dim=-1))
    njvj, col_nnv, m6, s6, b_nv, sv = _step_columns(ctx)

    def run(name, cid):
        alpha = cfg.alphas[cid]
        if name == "flat":
            return _flat_tile(ctx, njvj, d_thr, alpha, deltas[cid])
        if name == "edge":
            return _edge_tile(ctx, s6, b_nv, d_thr, alpha, te)
        if name == "corner":
            return _corner_tile(ctx, s6, b_nv, d_thr, alpha)
        if name == "feature":
            return _feature_like_tile(ctx, s6, b_nv, sv, d_thr, alpha)
        if name == "new":
            return _new_tile(ctx, njvj, col_nnv, m6, d_thr, alpha, deltas[cid])
        if name == "dummy":
            return tp
        raise ValueError(name)

    outs = [run(strategy[c], c) for c in range(3)]
    return torch.where((tc == 0)[..., None], outs[0],
                       torch.where((tc == 1)[..., None], outs[1], outs[2]))


def threshold_tile(tp, wp, col_valid, row_ok, cfg: DenoiseConfig):
    """The stale thresholds' sweep: per row the feature_k-th and step_k-th
    smallest window distances, and per tile the sum of the 6-NN edge
    lengths (the self edge included) over valid rows and their count."""
    d = _dist_tile(tp, wp, col_valid)
    d6 = _k_smallest(d, 6)
    dist6 = torch.sqrt(torch.where(torch.isfinite(d6), d6, 0.0))
    return (_kth_smallest(d, cfg.feature_k), _kth_smallest(d, cfg.step_k),
            torch.sum(torch.where(row_ok[..., None], dist6, 0.0), dim=(1, 2)),
            torch.sum(row_ok, dim=1) * 6)


def fused_denoise(
    points,
    normals,
    cfg: DenoiseConfig = DenoiseConfig(),
    strategy: tuple[str, str, str] = DEFAULT_STRATEGY,
    iterations: Optional[int] = None,
    num_valid: Optional[int] = None,
    tile: int = 256,
    window: int = 512,
    group: int = 4,
    threshold_method: str = "exact",
    threshold_refresh: int = 1,
    threshold_slack: float = 1.05,
    device=None,
):
    """Windowed equivalent of ``core.pipeline.denoise``.

    Returns (points, normals, classes int32) in the original point order
    on ``device`` (default ``"cuda"``). ``window`` is the one-sided
    Morton-index search radius; windows of at least the cloud size make
    the neighbour sets exact.

    ``threshold_refresh``: nonzero recomputes the per-point k-th-distance
    thresholds every iteration (exact kNN semantics); 0 computes them once
    on the noisy input and reuses them scaled by ``threshold_slack``, as
    the reference's KD-tree is built once on the noisy positions.
    """
    iters = cfg.iterations if iterations is None else iterations
    if iters < 1:
        raise ValueError("fused_denoise needs at least one iteration")
    if threshold_method not in THRESHOLD_METHODS:
        raise ValueError(f"threshold_method must be one of {THRESHOLD_METHODS}, "
                         f"got {threshold_method!r}")
    dev = resolve_device(device)
    exact_float32()
    pts = torch.as_tensor(points, dtype=torch.float32).to(dev)
    nrm = torch.as_tensor(normals, dtype=torch.float32).to(dev)
    n_in = pts.shape[0]
    nv = n_in if num_valid is None else int(num_valid)

    # Pad to a tile multiple; padding sorts to the end.
    n = -(-n_in // tile) * tile
    if n != n_in:
        pad = torch.zeros((n - n_in, 3), dtype=torch.float32, device=dev)
        pts, nrm = torch.cat([pts, pad]), torch.cat([nrm, pad])
    sc = morton_sort(pts, nrm, nv)
    geo = _Tiles(n, nv, tile, window, group, dev)
    cos_rho = torch.cos(torch.tensor(cfg.angle, dtype=torch.float32, device=dev))

    # One sweep on the noisy input: the d threshold, 2 * mean 6-NN edge
    # length (Processor.py:120-121), and the stale thresholds.
    def thr(t, col_valid, row_ok, tl, wn):
        return threshold_tile(tl[0], wn[0], col_valid, row_ok, cfg)

    rk_feat, rk_step, sums, counts = geo.map(thr, sc.pos)
    d_thr = cfg.d_scale * torch.sum(sums) / torch.clamp(torch.sum(counts), min=1)

    needs_delta = tuple(c for c in range(3) if strategy[c] in ("flat", "new"))

    def one_iteration(pos, nrm, rk_feat0, rk_step0):
        # Pass A: NVT1 + VU smoothing -> f_n, with the thresholds
        # recomputed here (threshold_refresh) or carried.
        def pass_a(t, col_valid, row_ok, tl, wn):
            tp, tn, trk, trk8 = tl
            d = _dist_tile(tp, wn[0], col_valid)
            if threshold_refresh:
                trk, trk8 = _kth_smallest(d, cfg.feature_k), _kth_smallest(d, cfg.step_k)
            return smooth_tile(tp, tn, wn[0], wn[1], d, trk, cos_rho, cfg), trk, trk8

        f_n, rk_feat, rk_step = geo.map(pass_a, pos, nrm, rk_feat0, rk_step0)
        f_n, rk_feat, rk_step = f_n.reshape(n, 3), rk_feat.reshape(n), rk_step.reshape(n)

        def pass_b(t, col_valid, row_ok, tl, wn):
            tp, _, trk, trk8 = tl
            d = _dist_tile(tp, wn[0], col_valid)
            return classify_tile(tp, wn[0], wn[1], d, trk, trk8, row_ok, cos_rho, cfg,
                                 needs_delta)

        cls, edge_vec, psums, pcnts = geo.map(pass_b, pos, f_n, rk_feat, rk_step)
        cls, edge_vec = cls.reshape(n), edge_vec.reshape(n, 3)
        centers = torch.sum(psums, dim=0) / torch.clamp(torch.sum(pcnts, dim=0), min=1.0)[:, None]

        # Pass C: delta = the largest distance from the class centre.
        deltas = {}
        if needs_delta:
            def pass_c(t, col_valid, row_ok, tl, wn):
                tp, tc, trk8 = tl
                d = _dist_tile(tp, wn[0], col_valid)
                return spread_tile(wn[0], d, tc, trk8, row_ok, centers, needs_delta)

            dmax = geo.map(pass_c, pos, cls, rk_step)
            deltas = {c: torch.amax(dmax[:, ci]) for ci, c in enumerate(needs_delta)}

        def pass_d(t, col_valid, row_ok, tl, wn):
            tp, tf, tc, te, trk8 = tl
            d = _dist_tile(tp, wn[0], col_valid)
            return update_tile(tp, tf, tc, te, wn[0], wn[1], d, trk8, cfg, strategy, d_thr,
                               deltas)

        new_pos = geo.map(pass_d, pos, f_n, cls, edge_vec, rk_step).reshape(n, 3)
        # Padding rows stay pinned.
        new_pos = torch.where((torch.arange(n, device=dev) < nv)[:, None], new_pos, pos)
        return new_pos, f_n, rk_feat, rk_step, cls

    # Stale thresholds are inflated by the slack so the moving points keep
    # about k neighbours inside; refreshed ones replace them in pass A.
    rk_feat = rk_feat.reshape(n) * threshold_slack
    rk_step = rk_step.reshape(n) * threshold_slack

    pos, nrm_s = sc.pos, sc.nrm
    for _ in range(iters):
        pos, nrm_s, rk_feat, rk_step, cls = one_iteration(pos, nrm_s, rk_feat, rk_step)

    # One scatter back to the original order.
    out_pos = unsort(pos, sc.orig_idx)[:n_in]
    out_nrm = unsort(nrm_s, sc.orig_idx)[:n_in]
    out_cls = unsort(cls.to(torch.int32)[:, None], sc.orig_idx)[:n_in, 0]
    return out_pos, out_nrm, out_cls
