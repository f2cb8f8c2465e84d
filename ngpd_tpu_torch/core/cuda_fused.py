"""The denoise engines on the card: the hybrid (window kernels + torch
per-point math) and the four-pass engine (everything in the kernels).

``denoise_hybrid`` ports ``ngpd_tpu/core/pallas_fused.py::pallas_denoise_hybrid``. The
chain is: Morton sort -> K0 (k-th distance thresholds, ``d_thr``) ->
per iteration: K1 (filtered NVT1; iteration 0 only under
``lagged_nvt1``) -> VU stage -> K2 (every window sum of the update) ->
update stage -> unsort. K0/K1/K2 are CUDA kernels on a card and their
plain PyTorch versions on the CPU (``kernels/window.py``); so are the
two per-point stages between them (``kernels/hybrid.py``, plain versions
``core/hybrid_stages.py``).

Semantics are the reference's: thresholds frozen at the noisy input,
lagged global deltas, and the same padding to ``tile * sub`` (the last
blocks' clipped window starts depend on the padded size, so ``sub`` is
kept although on the card it changes nothing else).

``denoise_passes`` ports ``pallas_denoise``. The chain is: pad to ``tile``
and Morton sort -> the prologue in torch (window distances, k-th smallest
thresholds, ``d_thr``) -> per iteration, in exact-delta mode: pass A
(NVT1, eigh, VU smoothing, the next packs) -> pass B (NVT2, classes,
delta-centre partials) -> pass C (delta spread, when a class needs one)
-> pass D (class-dispatched update); in lagged-delta mode: pass A -> the
fused pass BD (B and D with the previous iteration's deltas, the next
packs and the next lag state's partials) -> unsort. The passes are CUDA
kernels on a card and their plain versions on the CPU
(``kernels/passes.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import DenoiseConfig
from ..device import exact_float32, resolve_device
from ..kernels import hybrid as khy
from ..kernels import passes as kp
from ..kernels import window as kw
from ..ops.morton import SortedCloud, morton_sort, unsort
from ..utils import prof
from . import hybrid_stages as hs
from .pipeline import DEFAULT_STRATEGY


def padded_size(n_in: int, tile: int, window: int, sub: int) -> tuple[int, int]:
    """(padded n, effective sub): pad to the ``tile * sub`` multiple; a
    cloud too small for a full shared window takes sub = 1."""
    dma = tile * sub
    n = -(-n_in // dma) * dma
    if n < dma + 2 * window and sub > 1:
        sub = 1
        n = -(-n_in // tile) * tile
    return n, sub


class HybridState(NamedTuple):
    """What the prologue hands to the iterations."""

    sorted: SortedCloud  # Morton-sorted padded cloud
    win: kw.Windows  # window geometry
    pack: torch.Tensor  # (8, n) slim pack with the slacked thresholds
    scal: torch.Tensor  # (8, 128) initial lag state
    d_thr: torch.Tensor  # 0-dim displacement threshold
    needs_delta: tuple  # classes with a lagged global delta
    lay: dict  # K2 row layout
    n_in: int  # input rows


def prologue(
    points,
    normals,
    cfg: DenoiseConfig = DenoiseConfig(),
    strategy: tuple[str, str, str] = DEFAULT_STRATEGY,
    num_valid: Optional[int] = None,
    tile: int = 256,
    window: int = 128,
    threshold_slack: float = 1.05,
    sub: int = 8,
    device=None,
) -> HybridState:
    """Pad, Morton-sort, run K0 and build the initial lag state."""
    dev = resolve_device(device)
    exact_float32()
    pts = torch.as_tensor(points, dtype=torch.float32).to(dev)
    nrm = torch.as_tensor(normals, dtype=torch.float32).to(dev)
    n_in = pts.shape[0]
    nv = n_in if num_valid is None else int(num_valid)

    n, sub = padded_size(n_in, tile, window, sub)
    if n != n_in:
        pad = torch.zeros((n - n_in, 3), dtype=torch.float32, device=dev)
        pts = torch.cat([pts, pad])
        nrm = torch.cat([nrm, pad])
    sc = morton_sort(pts, nrm, nv)
    win = kw.make_windows(n, nv, tile, window, sub, dev)
    needs_delta = hs.needs_delta_of(strategy)

    pos0 = sc.pos.T.contiguous()
    pack = hs.build_pack_slim(pos0, sc.nrm.T.contiguous())
    pro = kw.k0(pack, win, cfg.feature_k, cfg.step_k)
    d_thr = cfg.d_scale * torch.sum(pro[2]) / torch.clamp(torch.sum(pro[3]), min=1.0)

    scal = kp.initial_lag_scal(pos0, nv, len(needs_delta))
    pack = hs.set_rk_slim(pack, pro[0] * threshold_slack, pro[1] * threshold_slack)
    return HybridState(sc, win, pack, scal, d_thr, needs_delta,
                       kw.k2_layout(strategy, needs_delta), n_in)


def denoise_hybrid(
    points,
    normals,
    cfg: DenoiseConfig = DenoiseConfig(),
    strategy: tuple[str, str, str] = DEFAULT_STRATEGY,
    iterations: Optional[int] = None,
    num_valid: Optional[int] = None,
    tile: int = 256,
    window: int = 128,
    threshold_method: str = "approx",
    threshold_slack: float = 1.05,
    sub: int = 8,
    lagged_nvt1: bool = False,
    device=None,
):
    """Hybrid engine. ``points``/``normals``: (N, 3) arrays or tensors.

    Returns ``(positions (N, 3), normals (N, 3), classes (N,) int32)`` on
    ``device`` (default ``"cuda"``). ``threshold_method`` is kept for
    signature parity and unused: K0 always computes the counting search's
    result (it selects the k-th smallest distances and replays the
    bisection against them).
    Nothing is copied to the host between iterations.
    """
    iters = cfg.iterations if iterations is None else iterations
    if iters < 1:
        raise ValueError("denoise_hybrid needs at least one iteration")
    dev = resolve_device(device)
    with prof.span("ngpd.hybrid", dev):
        with prof.span("ngpd.hybrid.prologue", dev):
            st = prologue(points, normals, cfg, strategy, num_valid, tile, window,
                          threshold_slack, sub, dev)
        pack, scal, lay, win = st.pack, st.scal, st.lay, st.win
        t6 = kw.k1(pack, win, cfg.angle) if lagged_nvt1 else None
        cls = None
        for _ in range(iters):
            if not lagged_nvt1:
                t6 = kw.k1(pack, win, cfg.angle)
            with prof.span("ngpd.hybrid.vu_stage", dev):
                pack2 = khy.vu_stage(t6, pack, cfg)
            k2out = kw.k2(pack2, scal, win, cfg.angle, strategy, len(st.needs_delta))
            with prof.span("ngpd.hybrid.update_stage", dev):
                pack, scal, cls = khy.update_stage(
                    k2out, pack2, st.d_thr, cfg, strategy, st.needs_delta, lay, win.nv
                )
            if lagged_nvt1:
                # K2's filtered-NVT rows of the post-VU normals are the next
                # iteration's K1 output (the reference's lagged_nvt1).
                t6 = k2out[lay["t6"] : lay["t6"] + 6]

        with prof.span("ngpd.hybrid.unsort", dev):
            idx, n_in = st.sorted.orig_idx, st.n_in
            out_pos = unsort(pack[0:3].T, idx)[:n_in]
            out_nrm = unsort(pack[3:6].T, idx)[:n_in]
            out_cls = unsort(cls.to(torch.int32)[:, None], idx)[:n_in, 0]
    return out_pos, out_nrm, out_cls


# ---------------------------------------------------------------------------
# The four-pass engine
# ---------------------------------------------------------------------------


class PassState(NamedTuple):
    """What the four-pass prologue hands to the iterations."""

    sorted: SortedCloud  # Morton-sorted padded cloud
    win: kw.Windows  # pass geometry (no sub)
    gq: torch.Tensor  # (16, n) GQ pack with the slacked thresholds
    gr: torch.Tensor  # (24, n) GR pack
    rk_feat: torch.Tensor  # (n,) slacked feature_k-th squared distances
    rk_step: torch.Tensor  # (n,) slacked step_k-th squared distances
    d_thr: torch.Tensor  # 0-dim displacement threshold
    needs_delta: tuple  # classes whose step needs a delta
    n_in: int  # input rows


def window_thresholds(pos: torch.Tensor, win: kw.Windows, feature_k: int,
                      step_k: int):
    """The reference's XLA prologue (pallas_fused.py:888-912) in torch.

    pos: (n, 3) sorted positions. Per query, over its window: the
    feature_k-th and step_k-th smallest squared distances, and the sum
    and count of the six smallest distances over valid rows. Distances
    are ``fused._dist_tile``'s ``|q|^2 + |p|^2 - 2 q.p`` at full float32,
    ``inf`` in invalid columns. Both threshold methods take the exact
    k-th smallest (``torch.topk``): the reference's ``approx`` is
    ``jax.lax.approx_min_k``, which is exact off the TPU.
    Returns (rk_feat (n,), rk_step (n,), sum6, count6), un-slacked."""
    n, t, wt = win.n, win.tile, win.wt_c
    k_max = max(feature_k, step_k, 6)
    if k_max > wt:
        raise ValueError(f"k = {k_max} exceeds the {wt}-column window")
    rkf = torch.empty(n, dtype=pos.dtype, device=pos.device)
    rk8 = torch.empty_like(rkf)
    ssum = torch.zeros((), dtype=pos.dtype, device=pos.device)
    cnt = torch.zeros((), dtype=pos.dtype, device=pos.device)
    cols = torch.arange(wt, device=pos.device)
    for b0, b1 in kp.chunks(win):
        q = pos[b0 * t : b1 * t].reshape(b1 - b0, t, 1, 3)
        idx = win.starts[b0:b1, None].long() + cols[None, :]
        w = pos[idx][:, None]  # (B, 1, wt, 3)
        aa = q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1] + q[..., 2] * q[..., 2]
        bb = w[..., 0] * w[..., 0] + w[..., 1] * w[..., 1] + w[..., 2] * w[..., 2]
        ab = q[..., 0] * w[..., 0] + q[..., 1] * w[..., 1] + q[..., 2] * w[..., 2]
        d = torch.clamp(aa + bb - 2.0 * ab, min=0.0)
        d = torch.where((idx < win.nv)[:, None, :], d, float("inf"))
        vals = torch.topk(d, k_max, dim=2, largest=False, sorted=True).values
        rows = slice(b0 * t, b1 * t)
        rkf[rows] = vals[..., feature_k - 1].reshape(-1)
        rk8[rows] = vals[..., step_k - 1].reshape(-1)
        d6 = vals[..., :6]
        dist6 = torch.sqrt(torch.where(torch.isfinite(d6), d6, 0.0))
        row_ok = (torch.arange(b0 * t, b1 * t, device=pos.device) < win.nv)
        ssum = ssum + torch.sum(torch.where(row_ok.reshape(b1 - b0, t, 1), dist6, 0.0))
        cnt = cnt + torch.sum(row_ok) * 6
    return rkf, rk8, ssum, cnt


def passes_prologue(
    points,
    normals,
    cfg: DenoiseConfig = DenoiseConfig(),
    strategy: tuple[str, str, str] = DEFAULT_STRATEGY,
    num_valid: Optional[int] = None,
    tile: int = 256,
    window: int = 128,
    threshold_method: str = "approx",
    threshold_slack: float = 1.05,
    device=None,
) -> PassState:
    """Pad to ``tile``, Morton-sort, build the packs and run the prologue."""
    if threshold_method not in ("approx", "exact"):
        raise ValueError(f"threshold_method must be 'approx' or 'exact', got "
                         f"{threshold_method!r}")
    dev = resolve_device(device)
    exact_float32()
    pts = torch.as_tensor(points, dtype=torch.float32).to(dev)
    nrm = torch.as_tensor(normals, dtype=torch.float32).to(dev)
    n_in = pts.shape[0]
    nv = n_in if num_valid is None else int(num_valid)
    n = -(-n_in // tile) * tile
    if n != n_in:
        pad = torch.zeros((n - n_in, 3), dtype=torch.float32, device=dev)
        pts = torch.cat([pts, pad])
        nrm = torch.cat([nrm, pad])
    sc = morton_sort(pts, nrm, nv)
    win = kw.make_windows(n, nv, tile, window, 1, dev)
    rkf, rk8, ssum, cnt = window_thresholds(sc.pos, win, cfg.feature_k, cfg.step_k)
    d_thr = cfg.d_scale * ssum / torch.clamp(cnt, min=1.0)
    rk_feat, rk_step = rkf * threshold_slack, rk8 * threshold_slack
    gq, gr = kp.build_packs(sc.pos.T.contiguous(), sc.nrm.T.contiguous())
    return PassState(sc, win, kp.set_rk(gq, rk_feat, rk_step), gr, rk_feat, rk_step,
                     d_thr, hs.needs_delta_of(strategy), n_in)


def denoise_passes(
    points,
    normals,
    cfg: DenoiseConfig = DenoiseConfig(),
    strategy: tuple[str, str, str] = DEFAULT_STRATEGY,
    iterations: Optional[int] = None,
    num_valid: Optional[int] = None,
    tile: int = 256,
    window: int = 128,
    threshold_method: str = "approx",
    threshold_slack: float = 1.05,
    delta_mode: str = "exact",
    device=None,
):
    """The pass engine, ``pallas_denoise``.

    Returns ``(positions (N, 3), normals (N, 3), classes (N,) int32)`` in
    the input order on ``device`` (default ``"cuda"``). With
    ``delta_mode="exact"`` the delta of each flat/new class is the current
    iteration's: its centre from pass B's partials, its spread from pass
    C. With ``"lagged"`` it is the previous iteration's, from the fused
    pass BD's partials, starting from the cloud's centroid and radius
    (l.1040-1056), and an iteration is two launches, A and BD. Either way
    the state is reduced on the device, so nothing is copied to the host
    between iterations.
    """
    if delta_mode not in ("exact", "lagged"):
        raise ValueError(f"delta_mode must be 'exact' or 'lagged', got {delta_mode!r}")
    iters = cfg.iterations if iterations is None else iterations
    if iters < 1:
        raise ValueError("denoise_passes needs at least one iteration")
    st = passes_prologue(points, normals, cfg, strategy, num_valid, tile, window,
                         threshold_method, threshold_slack, device)
    win, nd = st.win, st.needs_delta
    gq, gr = st.gq, st.gr
    cls = None
    if delta_mode == "lagged":
        scal = kp.initial_lag_scal(gq[0:3], win.nv, len(nd), st.d_thr)
        for _ in range(iters):
            gq2, gr2 = kp.pass_a(gq, gr, win, cfg)
            gq, gr, cls, parts = kp.pass_bd(gq2, gr2, scal, win, cfg, strategy, nd)
            scal = kp.lag_scal(st.d_thr, parts)
    else:
        valid = torch.arange(win.n, device=gq.device) < win.nv
        for _ in range(iters):
            gq2, gr2 = kp.pass_a(gq, gr, win, cfg)
            cls4, parts = kp.pass_b(gq2, gr2, win, cfg, nd)
            scal = kp.delta_scal(st.d_thr, parts)
            if nd:
                scal = kp.delta_scal(st.d_thr, parts, kp.pass_c(gq2, gr2, cls4, scal, win, nd))
            newp = kp.pass_d(gq2, gr2, cls4, scal, win, cfg, strategy, nd)
            new_pos = torch.where(valid, newp, gq[0:3])
            gq, gr = kp.build_packs(new_pos, gq2[5:8])
            gq = kp.set_rk(gq, st.rk_feat, st.rk_step)
            cls = cls4[0]

    idx, n_in = st.sorted.orig_idx, st.n_in
    out_pos = unsort(gq[0:3].T, idx)[:n_in]
    out_nrm = unsort(gq[5:8].T, idx)[:n_in]
    out_cls = unsort(cls.to(torch.int32)[:, None], idx)[:n_in, 0]
    return out_pos, out_nrm, out_cls
