"""Plain reference of the windowed normal-voting denoise of large clouds
(the engine that the command line takes for 100,000 points and more).

Semantics, those of the reference engine ``pallas_denoise_hybrid``:
  * the cloud padded to a multiple of tile x sub and sorted in Z order
    (Morton codes, 10 bits an axis, stable);
  * each block of ``tile`` sorted queries sees the window columns
    [start, start + wt_c), start = clamp(b tile - window, 0, n - wt_c);
  * thresholds once, on the noisy input: the feature_k-th and step_k-th
    smallest squared window distances and the 6 smallest for d, each by a
    24-step bisection on counts (the approximate method), slacked by 1.05;
    d_thr = d_scale x the mean of the 6 smallest distances;
  * per iteration: the filtered NVT over d <= rk_feat (lagged: from the
    previous iteration's window sums after the first), VU smoothing, every
    window sum of the update over d <= rk_step with the post-VU normals,
    classes from the filtered NVT of those normals, the class steps, and
    the lagged global delta (centre and spread) of the flat class;
  * the result unsorted to the input's order.

Window sums are ``numerics.contract`` over (blocks, tile, columns); the
per-point algebra is elementwise.
"""

from __future__ import annotations

import math

import torch

from .numerics import (
    classes_c, clamp_step, contract, edge_solve, eigh3x3_components, flat_step,
    select_by_class, solve3x3_components, srow, three_term_solve, vu_filter_components,
)

_MASKED = 1e30
_SEARCH_ITERS = 24


# --- ordering and windows ----------------------------------------------------

def _part1by2(v):
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_order(points: torch.Tensor, nv: int):
    """(sorted positions with padding rows at a far corner, order)."""
    n = points.shape[0]
    valid = torch.arange(n, device=points.device) < nv
    v3 = valid[:, None]
    safe = torch.where(v3, points, torch.zeros_like(points))
    inf = torch.tensor(float("inf"), dtype=points.dtype, device=points.device)
    mn = torch.where(v3, safe, inf).amin(dim=0)
    mx = torch.where(v3, safe, -inf).amax(dim=0)
    top = torch.full_like(mx, 1023.0)
    scale = top / torch.clamp(mx - mn, min=1e-30)
    cell = torch.clamp(((safe - mn) * scale).to(torch.int32), 0, 1023)
    code = _part1by2(cell[:, 0]) | (_part1by2(cell[:, 1]) << 1) | (_part1by2(cell[:, 2]) << 2)
    code = torch.where(valid, code, torch.full_like(code, 2**30))
    far = torch.where(v3, points, -inf).amax(dim=0) + 1.0
    pts = torch.where(v3, points, far)
    _, order = torch.sort(code, stable=True)
    return pts[order], order


def windows(n: int, tile: int, window: int, sub: int, device):
    wt = min(tile * sub + 2 * window, n)
    wt_c = wt - (sub - 1) * tile
    starts = torch.clamp(torch.arange(n // tile, device=device) * tile - window, 0, n - wt_c)
    return wt_c, starts


class Blocks:
    """Groups of query blocks, each group's (B, T, W) window operands."""

    def __init__(self, n, nv, tile, wt_c, starts, group):
        self.n, self.nv, self.t, self.w = n, nv, tile, wt_c
        self.starts, self.group = starts, group

    def __iter__(self):
        nb = self.n // self.t
        for b0 in range(0, nb, self.group):
            b1 = min(b0 + self.group, nb)
            cols = self.starts[b0:b1, None] + torch.arange(self.w, device=self.starts.device)
            yield slice(b0 * self.t, b1 * self.t), cols


def _q(pack, rows, b, t):
    """Query rows of a group as (R, B, T, 1)."""
    return pack[:, rows].reshape(pack.shape[0], b, t, 1)


def _sq(q, w):
    """max(|q|^2 + |p|^2 - 2 q.p, 0) as (B, T, W)."""
    p2q = q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
    p2w = (w[0] * w[0] + w[1] * w[1] + w[2] * w[2])[:, None, :]
    d = (q[0] * (-2.0 * w[0][:, None, :]) + q[1] * (-2.0 * w[1][:, None, :])
         + q[2] * (-2.0 * w[2][:, None, :]))
    return torch.clamp(d + p2w + p2q, min=0.0)


def _kth_by_count(d, k, dmax):
    lo = torch.zeros_like(dmax)
    hi = dmax
    for _ in range(_SEARCH_ITERS):
        mid = 0.5 * (lo + hi)
        ge = (d <= mid).sum(dim=-1, keepdim=True) >= k
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid)
    return hi[..., 0]


# --- window sums -------------------------------------------------------------

def thresholds(pos, blocks: Blocks, feature_k, step_k):
    """(rk_feat, rk_step, sum of the 6 smallest distances, their count)."""
    n, t = blocks.n, blocks.t
    rkf = torch.empty(n, dtype=pos.dtype, device=pos.device)
    rks = torch.empty_like(rkf)
    s6 = torch.zeros((), dtype=torch.float64, device=pos.device)
    c6 = torch.zeros((), dtype=torch.float64, device=pos.device)
    for rows, cols in blocks:
        b = cols.shape[0]
        q = _q(pos, rows, b, t)
        w = pos[:, cols]
        d = _sq(q, w)
        valid = (cols < blocks.nv)[:, None, :]
        dmax = torch.where(valid, d, 0.0).amax(dim=-1, keepdim=True) + 1.0
        d = torch.where(valid, d, dmax)
        rk6 = _kth_by_count(d, 6, dmax)
        in6 = (d <= rk6[..., None]).to(d.dtype)
        row_ok = (torch.arange(rows.start, rows.stop, device=pos.device) < blocks.nv)
        row_ok = row_ok.reshape(b, t).to(d.dtype)
        rkf[rows] = _kth_by_count(d, feature_k, dmax).reshape(-1)
        rks[rows] = _kth_by_count(d, step_k, dmax).reshape(-1)
        s6 += (torch.sum(torch.sqrt(d) * in6, dim=-1) * row_ok).sum(dtype=torch.float64)
        c6 += (torch.sum(in6, dim=-1) * row_ok).sum(dtype=torch.float64)
    return rkf, rks, s6, c6


def _dotj(q, w):
    """n_j.(p_j - p_i) as p_j.n_j - p_i.n_j, (B, T, W)."""
    pn = (w[0] * w[3] + w[1] * w[4] + w[2] * w[5])[:, None, :]
    return pn - (q[0] * w[3][:, None, :] + q[1] * w[4][:, None, :] + q[2] * w[5][:, None, :])


def _sym6(w):
    return torch.stack([w[3] * w[3], w[3] * w[4], w[3] * w[5],
                        w[4] * w[4], w[4] * w[5], w[5] * w[5]], dim=-1)  # (B, W, 6)


def _nvt(d, rkf, dotj, sym6, cos_rho):
    mk = (d <= rkf) & (d < _MASKED)
    cosang = torch.abs(dotj) * (1.0 / torch.sqrt(torch.clamp(d, min=1e-24)))
    wf = ((cosang < cos_rho) & mk).to(d.dtype)
    rescue = wf.sum(dim=-1, keepdim=True) == 0.0
    wf = torch.where(rescue, mk.to(d.dtype), wf)
    wsum = torch.clamp(wf.sum(dim=-1), min=1.0)
    return contract("btw,bwc->btc", wf, sym6) / wsum[..., None]


def _window(pack, rows, cols, blocks):
    b = cols.shape[0]
    q = _q(pack, rows, b, blocks.t)
    w = pack[:, cols]
    d = _sq(q, w)
    d = torch.where((cols < blocks.nv)[:, None, :], d, _MASKED)
    return q, w, d


def nvt1(pack, blocks: Blocks, cos_rho):
    """(6, n) filtered NVT sums of the pack [p, n, rk_feat, rk_step]."""
    out = torch.zeros((6, blocks.n), dtype=pack.dtype, device=pack.device)
    for rows, cols in blocks:
        q, w, d = _window(pack, rows, cols, blocks)
        t6 = _nvt(d, q[6], _dotj(q, w), _sym6(w), cos_rho)
        out[:, rows] = t6.reshape(-1, 6).T
    return out


def update_sums(pack, scal, blocks: Blocks, cos_rho, strategy, nd):
    """Every window sum of the update over the post-VU pack, as a dict of
    (rows, n) tensors."""
    names = ["t6", "s6", "b_nv", "sv"]
    if "edge" in strategy:
        names.append("q18")
    if "flat" in strategy:
        names.append("flat")
    if "new" in strategy:
        names.append("new")
    names += ["deg", "maxd"]
    parts = {k: [] for k in names}
    for rows, cols in blocks:
        q, w, d = _window(pack, rows, cols, blocks)
        dotj, sym6 = _dotj(q, w), _sym6(w)
        parts["t6"].append(_nvt(d, q[6], dotj, sym6, cos_rho))
        m8 = ((d <= q[7]) & (d < _MASKED)).to(d.dtype)
        pn = w[0] * w[3] + w[1] * w[4] + w[2] * w[5]
        nnv = torch.stack([w[3 + r] * pn for r in range(3)], dim=-1)
        pw = torch.stack([w[0], w[1], w[2]], dim=-1)
        parts["s6"].append(contract("btw,bwc->btc", m8, sym6))
        parts["b_nv"].append(contract("btw,bwc->btc", m8, nnv))
        parts["sv"].append(contract("btw,bwc->btc", m8, pw))
        if "edge" in strategy:
            qq = []
            for c, a in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
                base = w[3 + c] * w[3 + a]
                qq += [base * w[j] for j in range(3)]
            parts["q18"].append(contract("btw,bwc->btc", m8, torch.stack(qq, dim=-1)))
        if "flat" in strategy:
            d2 = torch.clamp(scal[1, 0] * scal[1, 0], min=1e-30)
            ninj = (q[3] * w[3][:, None, :] + q[4] * w[4][:, None, :] + q[5] * w[5][:, None, :])
            sim = torch.exp(-16.0 * (2.0 - 2.0 * ninj) / d2)
            close = torch.exp(-4.0 * torch.where(d < _MASKED, d, 0.0) / d2)
            wb = sim * close * m8
            parts["flat"].append(torch.stack([torch.sum(wb * dotj, dim=-1),
                                              torch.sum(wb, dim=-1)], dim=-1))
        if "new" in strategy:
            d2 = torch.clamp(scal[2, 0] * scal[2, 0], min=1e-30)
            like = torch.exp(-9.0 * dotj * dotj / d2) * m8
            parts["new"].append(torch.cat([contract("btw,bwc->btc", like, sym6),
                                           contract("btw,bwc->btc", like, nnv),
                                           contract("btw,bwc->btc", like, pw)], dim=-1))
        parts["deg"].append(torch.sum(m8, dim=-1, keepdim=True))
        p2w = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
        maxd = []
        for ci in range(nd):
            c0, c1, c2 = scal[4 + ci, 0], scal[4 + ci, 1], scal[4 + ci, 2]
            dist2 = p2w - 2.0 * (w[0] * c0 + w[1] * c1 + w[2] * c2) + (c0 * c0 + c1 * c1 + c2 * c2)
            maxd.append(torch.amax(m8 * dist2[:, None, :], dim=-1))
        parts["maxd"].append(torch.stack(maxd, dim=-1) if maxd
                             else d.new_zeros(d.shape[:2] + (0,)))
    return {k: torch.cat([x.reshape(-1, x.shape[-1]) for x in v]).T for k, v in parts.items()}


# --- per-point stages --------------------------------------------------------

def vu(t6, pack, cfg):
    f = vu_filter_components(tuple(t6[r] for r in range(6)), (pack[3], pack[4], pack[5]),
                             cfg["vu_tau"], cfg["vu_damping"])
    return torch.cat([pack[0:3], f[0][None], f[1][None], f[2][None], pack[6:8]], dim=0)


def update(s, pack2, d_thr, cfg, strategy, needs_delta, nv):
    """(next pack, next lag state, classes) from the window sums."""
    n = pack2.shape[1]
    p_i = (pack2[0], pack2[1], pack2[2])
    n_i = (pack2[3], pack2[4], pack2[5])
    w, v = eigh3x3_components(*(s["t6"][r] for r in range(6)))
    cls = classes_c(w, cfg["class_scale"])
    y = v[0]
    s6 = tuple(s["s6"][r] for r in range(6))
    b_nv = tuple(s["b_nv"][r] for r in range(3))
    sv = tuple(s["sv"][r] for r in range(3))
    deg = s["deg"][0]
    results = {}
    for cid, name in enumerate(strategy):
        alpha = cfg["alphas"][cid]
        if name == "flat":
            results[cid] = flat_step(s["flat"][0], s["flat"][1], n_i, p_i, alpha, d_thr)
        elif name == "edge":
            q = s["q18"]
            pidx = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 1): 3, (1, 2): 4, (2, 2): 5}
            pidx.update({(a, c): i for (c, a), i in list(pidx.items())})
            q_yy = tuple(sum(q[pidx[(c, a)] * 3 + b] * y[a] * y[b]
                             for a in range(3) for b in range(3)) for c in range(3))
            results[cid] = clamp_step(edge_solve(y, s6, b_nv, q_yy, deg, p_i), p_i, alpha, d_thr)
        elif name == "corner":
            opt, _ = solve3x3_components(srow(s6), b_nv, p_i)
            results[cid] = clamp_step(opt, p_i, alpha, d_thr)
        elif name == "feature":
            results[cid] = clamp_step(three_term_solve(n_i, p_i, deg, s6, b_nv, sv),
                                      p_i, alpha, d_thr)
        elif name == "new":
            nw = s["new"]
            results[cid] = clamp_step(
                three_term_solve(n_i, p_i, deg, tuple(nw[r] for r in range(6)),
                                 tuple(nw[6 + r] for r in range(3)),
                                 tuple(nw[9 + r] for r in range(3))), p_i, alpha, d_thr)
        else:
            results[cid] = p_i
    new_p = select_by_class(cls, results)
    valid = torch.arange(n, device=pack2.device) < nv
    new_p = tuple(torch.where(valid, a, b) for a, b in zip(new_p, p_i))
    scal = torch.zeros((8, 128), dtype=pack2.dtype, device=pack2.device)
    scal[0, 0] = d_thr
    for ci, c in enumerate(needs_delta):
        mask_c = ((cls == float(c)) & valid).to(pack2.dtype)
        cnt = torch.clamp(torch.sum(deg * mask_c), min=1.0)
        scal[4 + ci, 0:3] = torch.sum(s["sv"] * mask_c[None, :], dim=1) / cnt
        scal[1 + ci, 0] = torch.sqrt(torch.clamp(torch.max(s["maxd"][ci] * mask_c), min=0.0))
    pack = torch.cat([new_p[0][None], new_p[1][None], new_p[2][None],
                      pack2[3:6], pack2[6:8]], dim=0)
    return pack, scal, cls


def initial_scal(pos, nv, nd):
    """The lag state before the first iteration: every delta class centred
    at the cloud's centroid, its spread the largest distance from it."""
    p = pos[:, :nv].to(torch.float64)
    c = p.mean(dim=1)
    r = torch.sqrt(torch.max(torch.sum((p - c[:, None]) ** 2, dim=0)))
    scal = torch.zeros((8, 128), dtype=pos.dtype, device=pos.device)
    for ci in range(nd):
        scal[4 + ci, 0:3] = c.to(pos.dtype)
        scal[1 + ci, 0] = r.to(pos.dtype)
    return scal


def denoise(points, normals, cfg: dict, hybrid: dict, iterations: int, group: int = 64):
    """(positions, normals, classes int32) in the input's order."""
    dev = points.device
    tile, window, sub = hybrid["tile"], hybrid["window"], hybrid["sub"]
    n_in = points.shape[0]
    dma = tile * sub
    n = -(-n_in // dma) * dma
    if n < dma + 2 * window and sub > 1:
        sub, n = 1, -(-n_in // tile) * tile
    pad = torch.zeros((n - n_in, 3), dtype=torch.float32, device=dev)
    pts = torch.cat([points.to(torch.float32), pad])
    nrm = torch.cat([normals.to(torch.float32), pad])
    pos, order = morton_order(pts, n_in)
    nrm = nrm[order]
    wt_c, starts = windows(n, tile, window, sub, dev)
    blocks = Blocks(n, n_in, tile, wt_c, starts, group)
    strategy = tuple(cfg["strategy"])
    needs_delta = tuple(c for c in range(3) if strategy[c] in ("flat", "new"))
    cos_rho = float(torch.tensor(math.cos(cfg["angle"]), dtype=torch.float32))
    rkf, rks, s6, c6 = thresholds(pos.T.contiguous(), blocks, cfg["feature_k"], cfg["step_k"])
    d_thr = (cfg["d_scale"] * s6 / torch.clamp(c6, min=1.0)).to(torch.float32)
    slack = hybrid["threshold_slack"]
    pack = torch.cat([pos.T, nrm.T, (rkf * slack)[None], (rks * slack)[None]], dim=0)
    scal = initial_scal(pack[0:3], n_in, len(needs_delta))
    lagged = hybrid["lagged_nvt1"]
    t6 = nvt1(pack, blocks, cos_rho) if lagged else None
    cls = None
    for _ in range(iterations):
        if not lagged:
            t6 = nvt1(pack, blocks, cos_rho)
        pack2 = vu(t6, pack, cfg)
        s = update_sums(pack2, scal, blocks, cos_rho, strategy, len(needs_delta))
        pack, scal, cls = update(s, pack2, d_thr, cfg, strategy, needs_delta, n_in)
        t6 = s["t6"]
    out = torch.empty_like(pack)
    out[:, order] = pack
    return out[0:3, :n_in].T, out[3:6, :n_in].T, cls.to(torch.int32)[torch.argsort(order)][:n_in]
