"""The pass engine's kernels, passes A-D and the fused pass BD: CUDA
wrappers and plain PyTorch versions.

Port of the pass half of ``ngpd_tpu/core/pallas_fused.py`` (the kernels
of ``pallas_denoise``, l.232-787: A-D for exact-delta mode, A and BD for
lagged-delta mode, and the packs of l.795-822). Every query tile of ``tile`` Morton-sorted points reads the
window columns ``[starts[b], starts[b] + wt)`` with
``wt = min(tile + 2 * window, n)`` and
``starts = clip(arange(n // tile) * tile - window, 0, n - wt)``
(l.880-884): ``window.make_windows`` with ``sub = 1``. Columns at or
past ``nv`` are masked at ``1e30`` (l.247), not ``inf``.

Layouts, the reference's where state crosses between passes:
  GQ (16, N): 0-2 p | 3 one | 4 |p|^2 | 5-7 n | 8 rk_feat | 9 rk_step
              | 10-15 zero
  GR (24, N): 0-2 -2p | 3 |p|^2 | 4 one | 5-7 n | 8 p.n | 9-14 sym6(n)
              | 15-17 p | 18-23 zero
  scal (8, 128): [0, 0] d_thr | [1 + ci, 0] delta of the ci-th class of
              ``needs_delta`` | [4 + ci, 0:3] that class's centre
Layouts of the port's own, compact where the reference pads to the TPU's
(8, 128) tiling:
  cls (4, N):   0 class (0./1./2.) | 1-3 edge direction (the reference's
                (8, N) cls pack, rows 4-7 zero)
  parts (4 nd, num_tiles): per delta class ci, rows 4ci..4ci+2 the sum of
                p_j and row 4ci+3 the count over the step-mask pairs of
                that class's valid rows (the reference keeps each tile's
                value in lane 0 of a (16, N) block)
  maxp (nd, num_tiles): per delta class, max |p_j - centre|^2 over the
                same pairs (the reference's (8, N) lane-0 block)
  new positions (3, N) (the reference's (8, N), rows 3-7 zero)
  pass BD's parts (5 nd, num_tiles): per delta class ci, rows 5ci..5ci+2
                the sum of p_j, row 5ci+3 the count and row 5ci+4 the max
                |p_j - previous centre|^2 over the step-mask pairs of
                that class's valid rows, and its classes (N,) (the
                reference's (16, N) block: lane 0 of each tile, row 15
                the classes)

A wrapper given CUDA tensors launches its kernel (``csrc/pass_*.cu``) on
the current stream and adds one to ``LAUNCHES[name]``; given CPU tensors
it runs the plain version; anything else raises. There is no fallback
from the kernel to the plain version. The plain versions work on chunks
of (tile, wt) blocks, with the reference's order for every quantity a
threshold mask reads: the distance is the 5-row contraction
``GQ[0:5]^T . GR[0:5]`` (l.112-113), summed in row order. Per-tile
partials are reductions over one block each, without atomics.
"""

from __future__ import annotations

import torch

from ..config import DenoiseConfig
from ..ops.eigh3 import eigh3x3_components
from ..ops.fastmath import acos_poly
from ..ops.solve3 import solve3x3_components
from ..ops.steps import (
    STEP_NAMES, clamp_step, classes_c, dot_c, edge_solve, flat_step, norm_c,
    select_by_class, srow, three_term_solve,
)
from . import window as kw

LAUNCHES = {"pass_a": 0, "pass_b": 0, "pass_c": 0, "pass_d": 0, "pass_bd": 0}
GQ_ROWS, GR_ROWS, CLS_ROWS = 16, 24, 4
_MASKED = 1e30
_CHUNK_ELEMS = 1 << 24  # (block, tile, wt) elements a chunk of the plain versions


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Packs
# ---------------------------------------------------------------------------


def build_packs(pos: torch.Tensor, nrm: torch.Tensor):
    """(3, N) positions and normals -> (GQ (16, N), GR (24, N)) with zero
    threshold rows (``_build_packs``, l.795-818)."""
    n = pos.shape[1]
    one = torch.ones((1, n), dtype=pos.dtype, device=pos.device)
    zero = torch.zeros((1, n), dtype=pos.dtype, device=pos.device)
    zeros6 = torch.zeros((6, n), dtype=pos.dtype, device=pos.device)
    p2 = (pos[0] * pos[0] + pos[1] * pos[1] + pos[2] * pos[2])[None]
    pn = (pos[0] * nrm[0] + pos[1] * nrm[1] + pos[2] * nrm[2])[None]
    sym6 = torch.stack([
        nrm[0] * nrm[0], nrm[0] * nrm[1], nrm[0] * nrm[2],
        nrm[1] * nrm[1], nrm[1] * nrm[2], nrm[2] * nrm[2],
    ])
    gq = torch.cat([pos, one, p2, nrm, zero, zero, zeros6])
    gr = torch.cat([-2.0 * pos, p2, one, nrm, pn, sym6, pos, zeros6])
    return gq.contiguous(), gr.contiguous()


def set_rk(gq: torch.Tensor, rk_feat, rk_step) -> torch.Tensor:
    out = gq.clone()
    out[8] = rk_feat
    out[9] = rk_step
    return out


def delta_scal(d_thr, parts: torch.Tensor, maxp=None) -> torch.Tensor:
    """The exact-delta state passes C and D read (l.1084-1100), built on
    the packs' device without a host sync: d_thr; per delta class, its
    centre, sum p_j / count from pass B's partials ``parts`` (4 nd,
    num_tiles); and, once pass C's maxima ``maxp`` (nd, num_tiles) are
    given, its delta, sqrt of the largest |p_j - centre|^2."""
    nd = parts.shape[0] // 4
    scal = torch.zeros((8, 128), dtype=torch.float32, device=parts.device)
    scal[0, 0] = d_thr
    if nd:
        tot = parts.reshape(nd, 4, -1).sum(dim=2)  # (nd, [sum p, count])
        scal[4 : 4 + nd, 0:3] = tot[:, 0:3] / torch.clamp(tot[:, 3:4], min=1.0)
    if maxp is not None and nd:
        scal[1 : 1 + nd, 0] = torch.sqrt(torch.clamp(maxp.amax(dim=1), min=0.0))
    return scal


def initial_lag_scal(pos: torch.Tensor, nv: int, nd: int, d_thr=None) -> torch.Tensor:
    """The lag state before the first iteration (l.1040-1056): every
    delta class starts from the centroid of the valid columns of ``pos``
    (3, N) and the cloud's radius about it. ``scal[0, 0]`` is ``d_thr``
    when given."""
    valid = torch.arange(pos.shape[1], device=pos.device) < nv
    centroid = torch.sum(torch.where(valid[None, :], pos, 0.0), dim=1) / max(nv, 1)
    radius0 = torch.sqrt(torch.max(torch.where(
        valid, torch.sum((pos - centroid[:, None]) ** 2, dim=0), 0.0
    )))
    scal = torch.zeros((8, 128), dtype=torch.float32, device=pos.device)
    if d_thr is not None:
        scal[0, 0] = d_thr
    scal[1 : 1 + nd, 0] = radius0
    scal[4 : 4 + nd, 0:3] = centroid
    return scal


def lag_scal(d_thr, parts: torch.Tensor) -> torch.Tensor:
    """The next lag state from pass BD's partials ``parts`` (5 nd,
    num_tiles), on their device without a host sync (l.1066-1079): per
    delta class, centre = sum p_j / max(count, 1) and delta = sqrt of the
    largest |p_j - previous centre|^2."""
    nd = parts.shape[0] // 5
    scal = torch.zeros((8, 128), dtype=torch.float32, device=parts.device)
    scal[0, 0] = d_thr
    if nd:
        per = parts.reshape(nd, 5, -1)
        tot = per[:, 0:4].sum(dim=2)
        scal[4 : 4 + nd, 0:3] = tot[:, 0:3] / torch.clamp(tot[:, 3:4], min=1.0)
        scal[1 : 1 + nd, 0] = torch.sqrt(torch.clamp(per[:, 4].amax(dim=1), min=0.0))
    return scal


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def chunks(win: kw.Windows):
    """(first, last + 1) block ranges of at most _CHUNK_ELEMS pairs."""
    nb = win.n // win.tile
    step = max(1, _CHUNK_ELEMS // (win.tile * win.wt_c))
    for b0 in range(0, nb, step):
        yield b0, min(b0 + step, nb)


def _tiles(pack: torch.Tensor, win: kw.Windows, b0: int, b1: int) -> torch.Tensor:
    """(rows, B, tile, 1): query rows of blocks b0..b1-1."""
    t = win.tile
    return pack[:, b0 * t : b1 * t].reshape(pack.shape[0], b1 - b0, t, 1)


def _window(pack: torch.Tensor, win: kw.Windows, b0: int, b1: int, rows: int):
    """((rows, B, 1, wt) window rows, (B, 1, wt) column validity)."""
    idx = (win.starts[b0:b1, None].long()
           + torch.arange(win.wt_c, device=pack.device)[None, :])
    return pack[:rows][:, idx][:, :, None, :], (idx < win.nv)[:, None, :]


def _row_valid(win: kw.Windows, b0: int, b1: int, device) -> torch.Tensor:
    """(B, tile, 1): query rows below nv."""
    r = torch.arange(b0 * win.tile, b1 * win.tile, device=device)
    return (r < win.nv).reshape(b1 - b0, win.tile, 1)


def _dist(tq, wr, col_valid):
    """max(GQ[0:5] . GR[0:5], 0), masked at 1e30; (B, tile, wt)."""
    d = tq[0] * wr[0] + tq[1] * wr[1] + tq[2] * wr[2] + wr[3] + tq[4]
    return torch.where(col_valid, torch.clamp(d, min=0.0), _MASKED)


def _nvt_eigh(tq, wr, d, cos_rho):
    """Filtered NVT over d <= rk_feat with the zero-weight rescue, then
    the eigendecomposition with the polynomial acos (l.157-173)."""
    mk = (d <= tq[8]) & (d < _MASKED)
    cross = tq[0] * wr[5] + tq[1] * wr[6] + tq[2] * wr[7]
    cosang = torch.abs(wr[8] - cross) * (1.0 / torch.sqrt(torch.clamp(d, min=1e-24)))
    wf = ((cosang < cos_rho) & mk).to(d.dtype)
    rescue = wf.sum(dim=-1, keepdim=True) == 0.0
    wf = torch.where(rescue, mk.to(d.dtype), wf)
    wsum = torch.clamp(wf.sum(dim=-1), min=1.0)
    t6 = [torch.sum(wf * wr[9 + r], dim=-1) / wsum for r in range(6)]
    return eigh3x3_components(*t6, acos_fn=acos_poly)


def vu_smooth(w, v, n, tau, damping):
    """VU-smoothed normals from the eigenpairs (``_vu_smooth_c``, l.61)."""
    acc = [damping * n[c] for c in range(3)]
    for i in range(3):
        keep = w[i] > tau
        proj = dot_c(v[i], n)
        for c in range(3):
            acc[c] = acc[c] + torch.where(keep, proj * v[i][c], 0.0)
    inv = 1.0 / torch.clamp(norm_c(acc), min=1e-12)
    return tuple(a * inv for a in acc)


def pass_a_plain(gq, gr, win: kw.Windows, cfg: DenoiseConfig):
    """NVT1 -> eigh -> VU smoothing; the next packs GQ2, GR2 (l.232-278)."""
    cos_rho = kw.cos_f32(cfg.angle)
    gq2 = torch.empty_like(gq)
    gr2 = torch.empty_like(gr)
    t = win.tile
    for b0, b1 in chunks(win):
        tq = _tiles(gq, win, b0, b1)
        wr, col_valid = _window(gr, win, b0, b1, 15)
        d = _dist(tq, wr, col_valid)
        w, v = _nvt_eigh(tq, wr, d, cos_rho)
        f = vu_smooth(w, v, (tq[5, ..., 0], tq[6, ..., 0], tq[7, ..., 0]),
                      cfg.vu_tau, cfg.vu_damping)
        p = tuple(tq[c, ..., 0] for c in range(3))
        cols = slice(b0 * t, b1 * t)
        rows_q = tq[..., 0].reshape(GQ_ROWS, -1)
        gq2[:, cols] = torch.cat([rows_q[0:5], torch.stack(f).reshape(3, -1),
                                  rows_q[8:16]])
        sym = (f[0] * f[0], f[0] * f[1], f[0] * f[2],
               f[1] * f[1], f[1] * f[2], f[2] * f[2])
        gr2[:, cols] = torch.cat([
            -2.0 * rows_q[0:3], rows_q[4:5], rows_q[3:4],
            torch.stack(f).reshape(3, -1), dot_c(p, f).reshape(1, -1),
            torch.stack(sym).reshape(6, -1), rows_q[0:3],
            torch.zeros((6, rows_q.shape[1]), dtype=gq.dtype, device=gq.device),
        ])
    return gq2, gr2


def pass_b_plain(gq2, gr2, win: kw.Windows, cfg: DenoiseConfig, needs_delta):
    """NVT2 -> eigh -> classes and edge directions; per tile and delta
    class, sum p_j and the count over the step mask (l.281-353, the
    exact-delta branch: ``lagged=True`` is never launched)."""
    cos_rho = kw.cos_f32(cfg.angle)
    n, t = win.n, win.tile
    cls = torch.empty((CLS_ROWS, n), dtype=gq2.dtype, device=gq2.device)
    parts = torch.empty((4 * len(needs_delta), n // t), dtype=gq2.dtype,
                        device=gq2.device)
    for b0, b1 in chunks(win):
        tq = _tiles(gq2, win, b0, b1)
        wr, col_valid = _window(gr2, win, b0, b1, 18)
        d = _dist(tq, wr, col_valid)
        w, v = _nvt_eigh(tq, wr, d, cos_rho)
        c = classes_c(w, cfg.class_scale)
        cls[:, b0 * t : b1 * t] = torch.stack([c, *v[0]]).reshape(CLS_ROWS, -1)
        m8 = (d <= tq[9]) & (d < _MASKED)
        row_valid = _row_valid(win, b0, b1, gq2.device)
        for ci, k in enumerate(needs_delta):
            mc = (m8 & (c[..., None] == float(k)) & row_valid).to(d.dtype)
            for comp in range(3):
                parts[4 * ci + comp, b0:b1] = torch.sum(mc * wr[15 + comp], dim=(1, 2))
            parts[4 * ci + 3, b0:b1] = torch.sum(mc, dim=(1, 2))
    return cls, parts


def _centre_dist2(wr, scal, ci):
    """|p_j - centre_ci|^2 from pack rows: |p|^2 + (-2p).c + |c|^2."""
    c0, c1, c2 = scal[4 + ci, 0], scal[4 + ci, 1], scal[4 + ci, 2]
    return wr[3] + (wr[0] * c0 + wr[1] * c1 + wr[2] * c2) + (c0 * c0 + c1 * c1 + c2 * c2)


def pass_c_plain(gq2, gr2, cls, scal, win: kw.Windows, needs_delta):
    """Per tile and delta class, max |p_j - centre|^2 over the step mask
    of that class's valid rows, 0 where masked (l.356-399)."""
    n, t = win.n, win.tile
    maxp = torch.empty((len(needs_delta), n // t), dtype=gq2.dtype, device=gq2.device)
    for b0, b1 in chunks(win):
        tq = _tiles(gq2, win, b0, b1)
        tc = _tiles(cls, win, b0, b1)
        wr, col_valid = _window(gr2, win, b0, b1, 4)
        d = _dist(tq, wr, col_valid)
        m8 = (d <= tq[9]) & (d < _MASKED) & _row_valid(win, b0, b1, gq2.device)
        for ci, k in enumerate(needs_delta):
            m = m8 & (tc[0] == float(k))
            masked = torch.where(m, _centre_dist2(wr, scal, ci), 0.0)
            maxp[ci, b0:b1] = torch.amax(masked, dim=(1, 2))
    return maxp


def _steps(tq, wr, d, cls, y, scal, cfg: DenoiseConfig, strategy, needs_delta):
    """Every step of the strategy on one chunk, then selected by class
    (the D part of l.402-560 and l.599-722). ``cls`` (B, tile) classes,
    ``y`` three (B, tile) rows of edge directions. Returns (new positions
    as three (B, tile) rows, the step mask (B, tile, wt) as floats)."""
    slot = {c: i for i, c in enumerate(needs_delta)}
    d_thr = scal[0, 0]
    m8f = ((d <= tq[9]) & (d < _MASKED)).to(d.dtype)
    p_i = tuple(tq[c, ..., 0] for c in range(3))
    n_i = tuple(tq[5 + c, ..., 0] for c in range(3))

    def wsum(weight, rows):
        return tuple(torch.sum(weight * r, dim=-1) for r in rows)

    nnv = tuple(wr[5 + c] * wr[8] for c in range(3))
    deg = torch.sum(m8f, dim=-1)
    s6 = wsum(m8f, wr[9:15])
    b_nv = wsum(m8f, nnv)
    sv = wsum(m8f, wr[15:18])
    dotj = wr[8] - (tq[0] * wr[5] + tq[1] * wr[6] + tq[2] * wr[7])

    results = {}
    for cid in range(3):
        name, alpha = strategy[cid], cfg.alphas[cid]
        if name in ("flat", "new"):
            delta = scal[1 + slot[cid], 0]
            d2 = torch.clamp(delta * delta, min=1e-30)
        if name == "flat":
            ninj = tq[5] * wr[5] + tq[6] * wr[6] + tq[7] * wr[7]
            sim = torch.exp(-16.0 * (2.0 - 2.0 * ninj) / d2)
            close = torch.exp(-4.0 * torch.where(d < _MASKED, d, 0.0) / d2)
            wb = sim * close * m8f
            results[cid] = flat_step(torch.sum(wb * dotj, dim=-1),
                                     torch.sum(wb, dim=-1), n_i, p_i, alpha, d_thr)
        elif name == "edge":
            y3 = tuple(c[..., None] for c in y)
            ny = y3[0] * wr[5] + y3[1] * wr[6] + y3[2] * wr[7]
            py = y3[0] * wr[15] + y3[1] * wr[16] + y3[2] * wr[17]
            q_yy = wsum(m8f * ny * py, wr[5:8])
            results[cid] = clamp_step(edge_solve(y, s6, b_nv, q_yy, deg, p_i),
                                      p_i, alpha, d_thr)
        elif name == "corner":
            opt, _ = solve3x3_components(srow(s6), b_nv, p_i)
            results[cid] = clamp_step(opt, p_i, alpha, d_thr)
        elif name == "feature":
            results[cid] = clamp_step(three_term_solve(n_i, p_i, deg, s6, b_nv, sv),
                                      p_i, alpha, d_thr)
        elif name == "new":
            like = torch.exp(-9.0 * dotj * dotj / d2) * m8f
            opt = three_term_solve(n_i, p_i, deg, wsum(like, wr[9:15]),
                                   wsum(like, nnv), wsum(like, wr[15:18]))
            results[cid] = clamp_step(opt, p_i, alpha, d_thr)
        elif name == "dummy":
            results[cid] = p_i
        else:
            raise ValueError(name)
    return select_by_class(cls, results), m8f


def pass_d_plain(gq2, gr2, cls, scal, win: kw.Windows, cfg: DenoiseConfig,
                 strategy, needs_delta):
    """Class-dispatched vertex updates with guarded 3x3 solves and the
    d_thr clamp; every step computed, then selected (l.402-560)."""
    n, t = win.n, win.tile
    out = torch.empty((3, n), dtype=gq2.dtype, device=gq2.device)
    for b0, b1 in chunks(win):
        tq = _tiles(gq2, win, b0, b1)
        tc = _tiles(cls, win, b0, b1)
        wr, col_valid = _window(gr2, win, b0, b1, 18)
        d = _dist(tq, wr, col_valid)
        new_p, _ = _steps(tq, wr, d, tc[0, ..., 0],
                          tuple(tc[1 + c, ..., 0] for c in range(3)), scal, cfg,
                          strategy, needs_delta)
        out[:, b0 * t : b1 * t] = torch.stack(new_p).reshape(3, -1)
    return out


def next_packs(pos: torch.Tensor, gq2: torch.Tensor):
    """The packs pass BD hands to the next iteration (l.730-756): those of
    the new positions ``pos`` (3, N) and the normals this iteration ran
    with (``gq2`` rows 5-7), the ones row and rows 8-15 of ``gq2`` carried
    over."""
    gq_n, gr_n = build_packs(pos, gq2[5:8])
    gq_n[3], gr_n[4] = gq2[3], gq2[3]
    gq_n[8:16] = gq2[8:16]
    return gq_n, gr_n


def pass_bd_plain(gq2, gr2, scal_prev, win: kw.Windows, cfg: DenoiseConfig,
                  strategy, needs_delta):
    """Passes B and D on one distance block (l.565-787): NVT2 -> classes
    and edge directions; the steps with those directions and the previous
    iteration's deltas, padding rows pinned; the next packs; per tile and
    delta class, sum p_j, the count and max |p_j - previous centre|^2
    over the step mask (0 where masked). Returns (GQ' (16, N), GR' (24,
    N), classes (N,), parts (5 nd, num_tiles))."""
    cos_rho = kw.cos_f32(cfg.angle)
    n, t = win.n, win.tile
    pos = torch.empty((3, n), dtype=gq2.dtype, device=gq2.device)
    cls_out = torch.empty(n, dtype=gq2.dtype, device=gq2.device)
    parts = torch.empty((5 * len(needs_delta), n // t), dtype=gq2.dtype,
                        device=gq2.device)
    for b0, b1 in chunks(win):
        tq = _tiles(gq2, win, b0, b1)
        wr, col_valid = _window(gr2, win, b0, b1, 18)
        d = _dist(tq, wr, col_valid)
        w, v = _nvt_eigh(tq, wr, d, cos_rho)
        c = classes_c(w, cfg.class_scale)
        new_p, m8f = _steps(tq, wr, d, c, v[0], scal_prev, cfg, strategy, needs_delta)
        row_valid = _row_valid(win, b0, b1, gq2.device)
        new_p = tuple(torch.where(row_valid[..., 0], q, tq[k, ..., 0])
                      for k, q in enumerate(new_p))
        cols = slice(b0 * t, b1 * t)
        cls_out[cols] = c.reshape(-1)
        pos[:, cols] = torch.stack(new_p).reshape(3, -1)

        for ci, k in enumerate(needs_delta):
            mc = m8f * ((c[..., None] == float(k)) & row_valid).to(d.dtype)
            for comp in range(3):
                parts[5 * ci + comp, b0:b1] = torch.sum(mc * wr[15 + comp], dim=(1, 2))
            parts[5 * ci + 3, b0:b1] = torch.sum(mc, dim=(1, 2))
            parts[5 * ci + 4, b0:b1] = torch.amax(
                mc * _centre_dist2(wr, scal_prev, ci), dim=(1, 2))
    return (*next_packs(pos, gq2), cls_out, parts)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(win: kw.Windows, **packs) -> bool:
    """Validate the operands, ``name=(tensor, rows)``; True when they lie
    on a CUDA device."""
    dev = None
    for name, (x, rows) in packs.items():
        if x.dtype != torch.float32 or x.dim() != 2:
            raise TypeError(f"{name} must be a 2-D float32 tensor, got {x.dtype} "
                            f"{tuple(x.shape)}")
        if tuple(x.shape) != (rows, win.n):
            raise ValueError(f"{name} shape {tuple(x.shape)} != ({rows}, {win.n})")
        if dev is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the other operands on {dev}")
        dev = x.device
        on_cuda = kw._check(x, rows, win)
    return on_cuda


def _check_scal(scal: torch.Tensor, like: torch.Tensor) -> None:
    if tuple(scal.shape) != (8, 128) or scal.dtype != torch.float32:
        raise ValueError(f"scal must be (8, 128) float32, got {tuple(scal.shape)}")
    if scal.device != like.device or not scal.is_contiguous():
        raise ValueError("scal must be contiguous on the packs' device")


def _delta_classes(needs_delta) -> tuple:
    nd = tuple(int(c) for c in needs_delta)
    if len(nd) > 3 or any(c not in (0, 1, 2) for c in nd) or len(set(nd)) != len(nd):
        raise ValueError(f"needs_delta must be distinct classes 0-2, got {needs_delta}")
    return nd + (-1,) * (3 - len(nd))


def pass_a(gq, gr, win: kw.Windows, cfg: DenoiseConfig):
    """Pass A: the next packs (GQ2 (16, N), GR2 (24, N)) with the
    VU-smoothed normals."""
    if not _check(win, gq=(gq, GQ_ROWS), gr=(gr, GR_ROWS)):
        return pass_a_plain(gq, gr, win, cfg)
    gq2, gr2 = torch.empty_like(gq), torch.empty_like(gr)
    kw.launch("pass_a", LAUNCHES, gq.data_ptr(), gr.data_ptr(), win.starts.data_ptr(),
              gq2.data_ptr(), gr2.data_ptr(), win.n, win.nv, win.tile, win.wt_c,
              kw.cos_f32(cfg.angle), cfg.vu_tau, cfg.vu_damping)
    return gq2, gr2


def pass_b(gq2, gr2, win: kw.Windows, cfg: DenoiseConfig, needs_delta):
    """Pass B: (cls (4, N), parts (4 nd, num_tiles))."""
    dc = _delta_classes(needs_delta)
    if not _check(win, gq2=(gq2, GQ_ROWS), gr2=(gr2, GR_ROWS)):
        return pass_b_plain(gq2, gr2, win, cfg, needs_delta)
    nd = len(needs_delta)
    cls = torch.empty((CLS_ROWS, win.n), dtype=torch.float32, device=gq2.device)
    parts = torch.empty((4 * nd, win.n // win.tile), dtype=torch.float32,
                        device=gq2.device)
    kw.launch("pass_b", LAUNCHES, gq2.data_ptr(), gr2.data_ptr(), win.starts.data_ptr(),
              cls.data_ptr(), parts.data_ptr(), win.n, win.nv, win.tile, win.wt_c,
              kw.cos_f32(cfg.angle), cfg.class_scale, nd, *dc)
    return cls, parts


def pass_c(gq2, gr2, cls, scal, win: kw.Windows, needs_delta):
    """Pass C: maxp (nd, num_tiles)."""
    dc = _delta_classes(needs_delta)
    if not needs_delta:
        raise ValueError("pass C needs at least one delta class")
    on_cuda = _check(win, gq2=(gq2, GQ_ROWS), gr2=(gr2, GR_ROWS), cls=(cls, CLS_ROWS))
    _check_scal(scal, gq2)
    if not on_cuda:
        return pass_c_plain(gq2, gr2, cls, scal, win, needs_delta)
    nd = len(needs_delta)
    maxp = torch.empty((nd, win.n // win.tile), dtype=torch.float32, device=gq2.device)
    kw.launch("pass_c", LAUNCHES, gq2.data_ptr(), gr2.data_ptr(), cls.data_ptr(),
              scal.data_ptr(), win.starts.data_ptr(), maxp.data_ptr(), win.n, win.nv,
              win.tile, win.wt_c, nd, *dc)
    return maxp


def _step_args(strategy, needs_delta, cfg: DenoiseConfig) -> tuple:
    """The kernels' step arguments: kinds (indices of STEP_NAMES), alphas
    and delta slots of classes 0-2."""
    kinds = tuple(STEP_NAMES.index(s) for s in strategy)  # ValueError if unknown
    slots = tuple(needs_delta.index(c) if c in needs_delta else -1 for c in range(3))
    for c in range(3):
        if strategy[c] in ("flat", "new") and slots[c] < 0:
            raise ValueError(f"class {c} ({strategy[c]}) needs a delta slot")
    return (*kinds, *(float(a) for a in cfg.alphas), *slots)


def pass_d(gq2, gr2, cls, scal, win: kw.Windows, cfg: DenoiseConfig, strategy,
           needs_delta):
    """Pass D: the new positions (3, N)."""
    _delta_classes(needs_delta)
    needs_delta = tuple(needs_delta)
    step_args = _step_args(strategy, needs_delta, cfg)
    on_cuda = _check(win, gq2=(gq2, GQ_ROWS), gr2=(gr2, GR_ROWS), cls=(cls, CLS_ROWS))
    _check_scal(scal, gq2)
    if not on_cuda:
        return pass_d_plain(gq2, gr2, cls, scal, win, cfg, strategy, needs_delta)
    out = torch.empty((3, win.n), dtype=torch.float32, device=gq2.device)
    kw.launch("pass_d", LAUNCHES, gq2.data_ptr(), gr2.data_ptr(), cls.data_ptr(),
              scal.data_ptr(), win.starts.data_ptr(), out.data_ptr(), win.n, win.nv,
              win.tile, win.wt_c, *step_args)
    return out


def pass_bd(gq2, gr2, scal_prev, win: kw.Windows, cfg: DenoiseConfig, strategy,
            needs_delta):
    """Pass BD: (GQ' (16, N), GR' (24, N), classes (N,), parts (5 nd,
    num_tiles)) from the post-pass-A packs and the previous lag state.
    The next packs are new buffers, never the inputs."""
    dc = _delta_classes(needs_delta)
    needs_delta = tuple(needs_delta)
    step_args = _step_args(strategy, needs_delta, cfg)
    on_cuda = _check(win, gq2=(gq2, GQ_ROWS), gr2=(gr2, GR_ROWS))
    _check_scal(scal_prev, gq2)
    if not on_cuda:
        return pass_bd_plain(gq2, gr2, scal_prev, win, cfg, strategy, needs_delta)
    nd = len(needs_delta)
    gq_n, gr_n = torch.empty_like(gq2), torch.empty_like(gr2)
    cls = torch.empty(win.n, dtype=torch.float32, device=gq2.device)
    parts = torch.empty((5 * nd, win.n // win.tile), dtype=torch.float32,
                        device=gq2.device)
    kw.launch("pass_bd", LAUNCHES, gq2.data_ptr(), gr2.data_ptr(), scal_prev.data_ptr(),
              win.starts.data_ptr(), gq_n.data_ptr(), gr_n.data_ptr(), cls.data_ptr(),
              parts.data_ptr(), win.n, win.nv, win.tile, win.wt_c,
              kw.cos_f32(cfg.angle), cfg.class_scale, *step_args, nd, *dc)
    return gq_n, gr_n, cls, parts
