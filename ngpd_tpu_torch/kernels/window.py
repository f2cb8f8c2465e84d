"""The hybrid engine's window kernels K0/K1/K2: CUDA wrappers and plain
PyTorch versions.

Each group of ``tile`` consecutive Morton-sorted queries (query block
``b``) reads the window columns ``[starts[b], starts[b] + wt_c)``; columns
at or past ``nv`` are masked. ``Windows`` carries that geometry;
``make_windows`` builds it exactly as ``ngpd_tpu/core/pallas_fused.py``
does (l.1538-1549), whose ``sub_starts`` are these ``starts``.

A wrapper given CUDA tensors launches its kernel (``csrc/k*.cu``) on the
current stream and adds one to ``LAUNCHES[name]``; given CPU tensors it
runs the plain version; anything else raises. There is no fallback from
the kernel to the plain version. The plain versions compute one
``(tile, wt_c)`` block at a time, with the same operation order as the
kernels and the reference for every quantity a threshold mask reads.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

LAUNCHES = {"k0": 0, "k1": 0, "k2": 0}
CUDA_ERROR_INVALID_VALUE = 1
_SEARCH_ITERS = 24
_MASKED = 1e30


def cos_f32(angle: float) -> float:
    """cos(angle) rounded to float32, the precision of every comparison."""
    return float(torch.tensor(math.cos(angle), dtype=torch.float32))


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Windows(NamedTuple):
    n: int  # padded point count
    nv: int  # real points; rows/columns >= nv are padding
    tile: int  # queries per block
    wt_c: int  # window columns per block
    starts: torch.Tensor  # (n // tile,) int32 window starts


def make_windows(n: int, nv: int, tile: int, window: int, sub: int,
                 device) -> Windows:
    """Window geometry of the reference engine for a cloud already padded
    to ``n`` (a multiple of ``tile * sub``) with the effective ``sub``."""
    wt = min(tile * sub + 2 * window, n)
    wt_c = wt - (sub - 1) * tile
    starts = torch.clamp(
        torch.arange(n // tile, dtype=torch.int32, device=device) * tile
        - window, 0, n - wt_c,
    ).to(torch.int32)
    return Windows(n=n, nv=int(nv), tile=tile, wt_c=wt_c, starts=starts)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _blocks(win: Windows):
    """(block index, window start) pairs, one (tile, wt_c) block each."""
    return enumerate(win.starts.tolist())


def _sq_dist(tq: torch.Tensor, wr: torch.Tensor) -> torch.Tensor:
    """max(|q|^2 + |p|^2 - 2 q.p, 0) over (T, W), in the order of the
    reference's 5-row contraction [q, 1, |q|^2] . [-2p, |p|^2, 1]."""
    q0, q1, q2 = tq[0][:, None], tq[1][:, None], tq[2][:, None]
    p2q = q0 * q0 + q1 * q1 + q2 * q2
    p2w = wr[0] * wr[0] + wr[1] * wr[1] + wr[2] * wr[2]
    d = q0 * (-2.0 * wr[0]) + q1 * (-2.0 * wr[1]) + q2 * (-2.0 * wr[2])
    d = d + p2w[None, :] + p2q
    return torch.clamp(d, min=0.0)


def _col_valid(s: int, win: Windows, device) -> torch.Tensor:
    return (s + torch.arange(win.wt_c, device=device)) < win.nv


def _sym6(nw):
    return torch.stack([
        nw[0] * nw[0], nw[0] * nw[1], nw[0] * nw[2],
        nw[1] * nw[1], nw[1] * nw[2], nw[2] * nw[2],
    ], dim=1)  # (W, 6)


def _dotj(tq, wr):
    """n_j.(p_j - p_i) as p_j.n_j - p_i.n_j, (T, W)."""
    pn = wr[0] * wr[3] + wr[1] * wr[4] + wr[2] * wr[5]
    cross = (tq[0][:, None] * wr[3] + tq[1][:, None] * wr[4]
             + tq[2][:, None] * wr[5])
    return pn[None, :] - cross


def _filtered_nvt(d, rkf, dotj, sym6, cos_rho):
    """Filtered NVT sums over d <= rkf with the zero-weight rescue,
    normalised by the kept count. Returns (T, 6)."""
    mk = (d <= rkf[:, None]) & (d < _MASKED)
    cosang = torch.abs(dotj) * (1.0 / torch.sqrt(torch.clamp(d, min=1e-24)))
    wf = ((cosang < cos_rho) & mk).to(d.dtype)
    rescue = wf.sum(dim=1, keepdim=True) == 0.0
    wf = torch.where(rescue, mk.to(d.dtype), wf)
    wsum = torch.clamp(wf.sum(dim=1), min=1.0)
    return (wf @ sym6) / wsum[:, None]


def _kth_by_count(d, k, dmax):
    lo = torch.zeros_like(dmax)
    hi = dmax
    for _ in range(_SEARCH_ITERS):
        mid = 0.5 * (lo + hi)
        ge = (d <= mid).sum(dim=1, keepdim=True) >= k
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid)
    return hi[:, 0]


def k0_plain(pack: torch.Tensor, win: Windows, feature_k: int,
             step_k: int) -> torch.Tensor:
    n, t = win.n, win.tile
    out = torch.zeros((8, n), dtype=pack.dtype, device=pack.device)
    rows = torch.arange(t, device=pack.device)
    for b, s in _blocks(win):
        tq = pack[:, b * t : (b + 1) * t]
        d = _sq_dist(tq, pack[:, s : s + win.wt_c])
        valid = _col_valid(s, win, pack.device)[None, :]
        dmax = torch.where(valid, d, 0.0).amax(dim=1, keepdim=True) + 1.0
        d = torch.where(valid, d, dmax)
        rk6 = _kth_by_count(d, 6, dmax)
        in6 = (d <= rk6[:, None]).to(d.dtype)
        row_valid = ((b * t + rows) < win.nv).to(d.dtype)
        out[0, b * t : (b + 1) * t] = _kth_by_count(d, feature_k, dmax)
        out[1, b * t : (b + 1) * t] = _kth_by_count(d, step_k, dmax)
        out[2, b * t : (b + 1) * t] = (
            torch.sum(torch.sqrt(torch.clamp(d, min=0.0)) * in6, dim=1)
            * row_valid
        )
        out[3, b * t : (b + 1) * t] = torch.sum(in6, dim=1) * row_valid
    return out


# ---------------------------------------------------------------------------
# K0's selection (csrc/k0.cu), plain copy
# ---------------------------------------------------------------------------

K0_CAP = 128  # candidate words a warp (K0_CAP in csrc/k0.cu)
K0_MAX_R = 4  # the largest r a lane keeps in registers (K0_MAX_R)
_PAD_KEY = 0xFFFFFFFF  # above every distance's bit pattern


def k0_lanes(wt_c: int) -> int:
    """Columns a lane of K0 holds at this window: the register kernel's
    CPL (4, 8, 16, 32 or 64), or wt_c / 32 rounded up past 2,048 columns
    (the shared-memory kernel)."""
    cpl = -(-wt_c // 32)
    return next((c for c in (4, 8, 16, 32, 64) if cpl <= c), cpl)


class K0Selection(NamedTuple):
    rk: torch.Tensor  # (3, Q) the searches' results for feature_k, step_k, 6
    bound: torch.Tensor  # (Q,) T, the candidates' bound (a distance of the row)
    candidates: torch.Tensor  # (Q,) int64 count(d <= T)
    slow: torch.Tensor  # (Q,) bool: the query takes the counting search


def _order_keys(d: torch.Tensor) -> torch.Tensor:
    """The kernel's sort keys: a distance's float32 bit pattern as an
    unsigned number, which orders +0 ... +inf as the floats and NaN above."""
    return d.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _replay(v: torch.Tensor, dmax: torch.Tensor) -> torch.Tensor:
    """The counting search's result where d_(k) = v: the same midpoints,
    hi = mid exactly where count(d <= mid) >= k, that is where v <= mid."""
    lo = torch.zeros_like(dmax)
    hi = dmax
    for _ in range(_SEARCH_ITERS):
        mid = 0.5 * (lo + hi)
        ge = v <= mid
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid)
    return hi


def k0_select_rows(d: torch.Tensor, dmax: torch.Tensor, feature_k: int, step_k: int,
                   cap: int = K0_CAP) -> K0Selection:
    """K0's selection on rows of distances in the kernel's lane layout: ``d``
    (Q, 32 cpl), column j of lane j % 32 (columns that do not exist hold
    +inf, those past nv ``dmax``), ``dmax`` (Q,). With K = max(feature_k,
    step_k, 6) and r = ceil(K / 16): each lane's r-th smallest key, T the
    ceil(K / r)-th smallest of those, the candidates d <= T, the capacity
    test, then each search replayed against the k-th smallest candidate;
    the counting search where the kernel takes it. Step for step the
    kernel's, on the keys the kernel sorts."""
    q, w = d.shape
    cpl = w // 32
    big = max(feature_k, step_k, 6)
    r = -(-big // 16)
    selectable = feature_k >= 1 and step_k >= 1 and r <= min(K0_MAX_R, cpl)
    keys = _order_keys(d)
    if selectable:
        rth = keys.view(q, cpl, 32).sort(dim=1).values[:, r - 1, :]
        t_key = rth.sort(dim=1).values[:, -(-big // r) - 1]
    else:
        t_key = torch.full((q,), _PAD_KEY, dtype=torch.int64, device=d.device)
    cand = keys <= t_key[:, None]
    count = cand.sum(dim=1)
    slow = (count > cap) | (not selectable)
    order = torch.where(cand, keys, _PAD_KEY).argsort(dim=1, stable=True)
    bound = d.gather(1, (keys == t_key[:, None]).to(torch.uint8).argmax(dim=1, keepdim=True))[:, 0]
    rk = []
    for k in (feature_k, step_k, 6):
        pos = min(max(k, 1), w) - 1  # a slow row's position is not used
        hi = _replay(d.gather(1, order[:, pos : pos + 1])[:, 0], dmax)
        if bool(slow.any()):
            hi[slow] = _kth_by_count(d[slow], k, dmax[slow, None])
        rk.append(hi)
    return K0Selection(torch.stack(rk), bound, count, slow)


def _block_dists(pack: torch.Tensor, win: Windows, blocks: slice):
    """The squared window distances of a range of query blocks in the
    order of _sq_dist, (blocks x tile, wt_c), and their column validity."""
    t = win.tile
    p = pack[0:3]
    starts = win.starts[blocks].long()
    cols = starts[:, None] + torch.arange(win.wt_c, device=pack.device)[None, :]
    w = p[:, cols]  # (3, B, W)
    q = p[:, blocks.start * t : blocks.stop * t].reshape(3, -1, t, 1)  # (3, B, T, 1)
    p2q = q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
    p2w = (w[0] * w[0] + w[1] * w[1] + w[2] * w[2])[:, None, :]
    d = (q[0] * (-2.0 * w[0][:, None, :]) + q[1] * (-2.0 * w[1][:, None, :])
         + q[2] * (-2.0 * w[2][:, None, :]))
    d = torch.clamp(d + p2w + p2q, min=0.0)
    valid = (cols < win.nv)[:, None, :].expand_as(d)
    return d.reshape(-1, win.wt_c), valid.reshape(-1, win.wt_c)


def k0_model(pack: torch.Tensor, win: Windows, feature_k: int, step_k: int,
             cap: int = K0_CAP) -> tuple[torch.Tensor, K0Selection]:
    """K0 as the kernel computes it, in plain torch: rows 0-3 of its
    output (rows 0, 1 and 3 those of k0_plain bit for bit) and the
    selection of every query (its candidates and whether it took the
    counting search), some 2^17 distances a query row at a time."""
    n, t = win.n, win.tile
    cpl = k0_lanes(win.wt_c)
    batch = max(1, (1 << 17) // (32 * cpl))
    out = torch.zeros((8, n), dtype=pack.dtype, device=pack.device)
    parts = []
    for b0 in range(0, n // t, batch):
        blocks = slice(b0, min(b0 + batch, n // t))
        d, valid = _block_dists(pack, win, blocks)
        dmax = torch.where(valid, d, 0.0).amax(dim=1, keepdim=True) + 1.0
        d = torch.where(valid, d, dmax)
        lanes = torch.full((d.shape[0], 32 * cpl), math.inf, dtype=d.dtype, device=d.device)
        lanes[:, : win.wt_c] = d
        sel = k0_select_rows(lanes, dmax[:, 0], feature_k, step_k, cap)
        rows = slice(blocks.start * t, blocks.stop * t)
        in6 = (d <= sel.rk[2][:, None]).to(d.dtype)
        row_valid = (torch.arange(rows.start, rows.stop, device=d.device) < win.nv).to(d.dtype)
        out[0, rows], out[1, rows] = sel.rk[0], sel.rk[1]
        out[2, rows] = torch.sum(torch.sqrt(torch.clamp(d, min=0.0)) * in6, dim=1) * row_valid
        out[3, rows] = torch.sum(in6, dim=1) * row_valid
        parts.append(sel)
    return out, K0Selection(*(torch.cat(x, dim=-1) for x in zip(*parts)))


def k1_plain(pack: torch.Tensor, win: Windows, cos_rho: float) -> torch.Tensor:
    n, t = win.n, win.tile
    out = torch.zeros((8, n), dtype=pack.dtype, device=pack.device)
    for b, s in _blocks(win):
        tq = pack[:, b * t : (b + 1) * t]
        wr = pack[:, s : s + win.wt_c]
        d = _sq_dist(tq, wr)
        d = torch.where(_col_valid(s, win, pack.device)[None, :], d, _MASKED)
        t6 = _filtered_nvt(d, tq[6], _dotj(tq, wr), _sym6(wr[3:6]), cos_rho)
        out[0:6, b * t : (b + 1) * t] = t6.T
    return out


def k2_layout(strategy, needs_delta) -> dict:
    """Row offsets of the K2 output pack."""
    lay = {}
    o = 0
    lay["t6"] = o; o += 6  # noqa: E702
    lay["s6"] = o; o += 6  # noqa: E702
    lay["b_nv"] = o; o += 3  # noqa: E702
    lay["sv"] = o; o += 3  # noqa: E702
    if "edge" in strategy:
        lay["q18"] = o; o += 18  # noqa: E702  sym (c,a) pairs x 3 p-components
    if "flat" in strategy:
        lay["flat"] = o; o += 2  # noqa: E702
    if "new" in strategy:
        lay["new"] = o; o += 12  # noqa: E702
    lay["deg"] = o; o += 1  # noqa: E702
    lay["jp"] = lay["sv"]  # sum_j m8 p_j: the sv rows, not re-emitted
    lay["maxd"] = o; o += len(needs_delta)  # noqa: E702
    lay["_total"] = o + ((-o) % 8)
    return lay


def k2_plain(pack: torch.Tensor, scal: torch.Tensor, win: Windows,
             cos_rho: float, strategy, nd: int) -> torch.Tensor:
    n, t = win.n, win.tile
    use_flat, use_edge, use_new = (
        "flat" in strategy, "edge" in strategy, "new" in strategy
    )
    out = torch.zeros((k2_layout(strategy, range(nd))["_total"], n), dtype=pack.dtype,
                      device=pack.device)
    for b, s in _blocks(win):
        tq = pack[:, b * t : (b + 1) * t]
        wr = pack[:, s : s + win.wt_c]
        d = _sq_dist(tq, wr)
        d = torch.where(_col_valid(s, win, pack.device)[None, :], d, _MASKED)
        dotj = _dotj(tq, wr)
        sym6 = _sym6(wr[3:6])
        rows = [_filtered_nvt(d, tq[6], dotj, sym6, cos_rho)]

        m8f = ((d <= tq[7][:, None]) & (d < _MASKED)).to(d.dtype)
        pn = wr[0] * wr[3] + wr[1] * wr[4] + wr[2] * wr[5]
        nnv = torch.stack([wr[3 + r] * pn for r in range(3)], dim=1)
        pw = wr[0:3].T
        rows += [m8f @ sym6, m8f @ nnv, m8f @ pw]
        if use_edge:
            q = []
            for c, a in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
                base = wr[3 + c] * wr[3 + a]
                q += [base * wr[bb] for bb in range(3)]
            rows.append(m8f @ torch.stack(q, dim=1))
        if use_flat:
            d2 = torch.clamp(scal[1, 0] * scal[1, 0], min=1e-30)
            ninj = (tq[3][:, None] * wr[3] + tq[4][:, None] * wr[4]
                    + tq[5][:, None] * wr[5])
            sim = torch.exp(-16.0 * (2.0 - 2.0 * ninj) / d2)
            close = torch.exp(-4.0 * torch.where(d < _MASKED, d, 0.0) / d2)
            wb = sim * close * m8f
            rows.append(torch.stack(
                [torch.sum(wb * dotj, dim=1), torch.sum(wb, dim=1)], dim=1
            ))
        if use_new:
            d2 = torch.clamp(scal[2, 0] * scal[2, 0], min=1e-30)
            like = torch.exp(-9.0 * dotj * dotj / d2) * m8f
            rows += [like @ sym6, like @ nnv, like @ pw]
        rows.append(torch.sum(m8f, dim=1)[:, None])
        p2w = wr[0] * wr[0] + wr[1] * wr[1] + wr[2] * wr[2]
        for ci in range(nd):
            c0, c1, c2 = scal[4 + ci, 0], scal[4 + ci, 1], scal[4 + ci, 2]
            dist2 = (p2w - 2.0 * (wr[0] * c0 + wr[1] * c1 + wr[2] * c2)
                     + (c0 * c0 + c1 * c1 + c2 * c2))
            rows.append(torch.amax(m8f * dist2[None, :], dim=1)[:, None])
        blk = torch.cat(rows, dim=1).T
        out[: blk.shape[0], b * t : (b + 1) * t] = blk
    return out


# ---------------------------------------------------------------------------
# The word skip of K2 and pass BD (csrc/walk_common.cuh), plain copy
# ---------------------------------------------------------------------------

_DIST_MARGIN = 16 * 2.0 ** -24  # dist_margin of walk_common.cuh


def mask_threshold(rk: torch.Tensor) -> torch.Tensor:
    """t with ``d <= t`` exactly where ``d <= rk and d < 1e30``."""
    top = torch.tensor(_MASKED, dtype=torch.float32)
    below = torch.nextafter(top, torch.zeros(())).to(rk.device)
    return torch.where(rk >= top.to(rk.device), below, rk)


def word_skippable(q_lo, q_hi, qq, thr, box_lo, box_hi, pp) -> torch.Tensor:
    """True where no query inside the box ``[q_lo, q_hi]`` (last axis x, y,
    z; squared norms up to ``qq``) can have a column of a word with
    positions inside ``[box_lo, box_hi]`` (squared norms up to ``pp``)
    within ``thr``: the squared gap between the boxes, lowered by its own
    rounding and by the computed distance's error bound of 16 ulps of
    ``qq + pp``, exceeds ``thr``. Operation for operation the kernels'
    ``word_skippable``; a NaN skips nothing."""
    gap = torch.clamp(torch.maximum(box_lo - q_hi, q_lo - box_hi), min=0.0)
    lb = gap[..., 0] * gap[..., 0]
    lb = lb + gap[..., 1] * gap[..., 1]
    lb = lb + gap[..., 2] * gap[..., 2]
    return lb * 0.99999 - _DIST_MARGIN * (qq + pp) > thr


def skippable_words(pos: torch.Tensor, rk_feat: torch.Tensor, rk_step: torch.Tensor,
                    win: Windows) -> torch.Tensor:
    """The kernels' decision for every (block, warp of 32 consecutive
    queries, word of 32 window columns), (n // tile, tile // 32, words)
    bool, from positions ``pos`` (3, n) and the two threshold rows. Words
    are those of the staged window: pitch ``wt_c`` rounded up to 32, zeros
    past ``wt_c``."""
    n, t = win.n, win.tile
    nb, words = n // t, -(-win.wt_c // 32)
    cols = torch.arange(words * 32, device=pos.device)
    idx = (win.starts.long()[:, None] + cols[None, :]).clamp(max=n - 1)
    pw = torch.where((cols < win.wt_c)[None, :, None], pos.T[idx], 0.0)
    ppw = pw[..., 0] * pw[..., 0] + pw[..., 1] * pw[..., 1] + pw[..., 2] * pw[..., 2]
    pw = pw.view(nb, 1, words, 32, 3)
    q = pos.T.reshape(nb, t // 32, 1, 32, 3)
    qq = (q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1] + q[..., 2] * q[..., 2]).amax(dim=3)
    thr = mask_threshold(torch.maximum(rk_feat, rk_step)).view(nb, t // 32, 1, 32).amax(dim=3)
    return word_skippable(q.amin(dim=3), q.amax(dim=3), qq, thr, pw.amin(dim=3),
                          pw.amax(dim=3), ppw.view(nb, 1, words, 32).amax(dim=3))


def skipped_word_share(pos, rk_feat, rk_step, win: Windows) -> float:
    """Share of the (warp, word) scans with a valid column that the
    kernels skip."""
    skip = skippable_words(pos, rk_feat, rk_step, win)
    live = torch.clamp(torch.clamp(win.nv - win.starts.long(), max=win.wt_c), min=0)
    has_valid = torch.arange(skip.shape[2], device=pos.device)[None, :] * 32 < live[:, None]
    total = int(has_valid.sum()) * skip.shape[1]
    return float((skip & has_valid[:, None, :]).sum()) / max(total, 1)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(pack: torch.Tensor, rows: int, win: Windows) -> bool:
    """Validate the operands; True when they lie on a CUDA device."""
    if pack.dtype != torch.float32 or pack.dim() != 2:
        raise TypeError(f"pack must be a 2-D float32 tensor, got {pack.dtype} "
                        f"{tuple(pack.shape)}")
    if pack.shape[0] < rows or pack.shape[1] != win.n:
        raise ValueError(f"pack shape {tuple(pack.shape)} != ({rows}, {win.n})")
    if not pack.is_contiguous():
        raise ValueError("pack must be contiguous")
    if win.n % win.tile or win.starts.numel() != win.n // win.tile:
        raise ValueError("window geometry does not match n and tile")
    if win.starts.dtype != torch.int32 or win.starts.device != pack.device:
        raise ValueError("starts must be int32 on the pack's device")
    if pack.device.type == "cpu":
        return False
    if pack.device.type != "cuda":
        raise RuntimeError(f"window kernels run on cuda or cpu, not {pack.device}")
    if win.tile % 32 or win.tile > 1024:
        raise ValueError(f"tile must be a multiple of 32 up to 1024, got {win.tile}")
    if not win.starts.is_contiguous():
        raise ValueError("starts must be contiguous")
    return True


class LaunchError(RuntimeError):
    """A launch that the kernel's launch function or the runtime refused."""

    def __init__(self, name: str, rc: int):
        super().__init__(f"{name} launch failed with cudaError {rc}")
        self.rc = rc


def launch(name: str, counts: dict, *args) -> None:
    """Launch kernel ``name`` on the current stream and count it in
    ``counts[name]``; raises LaunchError if the launch is refused."""
    from .build import load_library

    fn = getattr(load_library(name), f"ngpd_{name}_launch")
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise LaunchError(name, rc)
    counts[name] += 1


def k0(pack: torch.Tensor, win: Windows, feature_k: int, step_k: int) -> torch.Tensor:
    """Prologue: rows rk_feat, rk_step (k-th squared window distances,
    un-slacked), sum6, cnt6, then zeros. Reads pack rows 0-2."""
    if not _check(pack, 3, win):
        return k0_plain(pack, win, feature_k, step_k)
    out = torch.empty((8, win.n), dtype=torch.float32, device=pack.device)
    try:
        launch("k0", LAUNCHES, pack.data_ptr(), win.starts.data_ptr(), out.data_ptr(),
               win.n, win.nv, win.tile, win.wt_c, int(feature_k), int(step_k))
    except LaunchError as err:
        if err.rc != CUDA_ERROR_INVALID_VALUE:
            raise
        raise ValueError(f"K0 refused a window of {win.wt_c} columns: the window and one "
                         "warp's row of distances exceed the shared memory a block can "
                         "use (K0_SMEM_LIMIT in csrc/k0.cu)") from err
    return out


def k1(pack: torch.Tensor, win: Windows, angle: float) -> torch.Tensor:
    """Filtered NVT1 of the slim pack [p, n, rk_feat, rk_step]: t6 in
    rows 0-5, rows 6-7 zero."""
    cos_rho = cos_f32(angle)
    if not _check(pack, 8, win):
        return k1_plain(pack, win, cos_rho)
    out = torch.empty((8, win.n), dtype=torch.float32, device=pack.device)
    launch("k1", LAUNCHES, pack.data_ptr(), win.starts.data_ptr(), out.data_ptr(),
            win.n, win.nv, win.tile, win.wt_c, cos_rho)
    return out


def k2(pack: torch.Tensor, scal: torch.Tensor, win: Windows, angle: float,
       strategy, nd: int) -> torch.Tensor:
    """Every window sum of the update stage over the post-VU pack, rows
    in ``k2_layout`` order; ``nd`` lagged-delta classes."""
    cos_rho = cos_f32(angle)
    if tuple(scal.shape) != (8, 128) or scal.dtype != torch.float32:
        raise ValueError(f"scal must be (8, 128) float32, got {tuple(scal.shape)}")
    if not 0 <= nd <= 3:
        raise ValueError(f"nd must be 0-3, got {nd}")
    if not _check(pack, 8, win):
        return k2_plain(pack, scal, win, cos_rho, strategy, nd)
    if scal.device != pack.device or not scal.is_contiguous():
        raise ValueError("scal must be contiguous on the pack's device")
    total = k2_layout(strategy, range(nd))["_total"]
    out = torch.empty((total, win.n), dtype=torch.float32, device=pack.device)
    launch("k2", LAUNCHES, pack.data_ptr(), win.starts.data_ptr(), scal.data_ptr(),
            out.data_ptr(), win.n, win.nv, win.tile, win.wt_c, cos_rho,
            int("flat" in strategy), int("edge" in strategy),
            int("new" in strategy), nd, total)
    return out
