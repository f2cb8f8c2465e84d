"""The hybrid denoise engine on the card: window kernels + torch per-point math.

Port of ``ngpd_tpu/core/pallas_fused.py::pallas_denoise_hybrid``. The
chain is: Morton sort -> K0 (k-th distance thresholds, ``d_thr``) ->
per iteration: K1 (filtered NVT1; iteration 0 only under
``lagged_nvt1``) -> VU stage -> K2 (every window sum of the update) ->
update stage -> unsort. K0/K1/K2 are CUDA kernels on a card and their
plain PyTorch versions on the CPU (``kernels/window.py``); the stages
between them are plain torch (``core/hybrid_stages.py``).

Semantics are the reference's: thresholds frozen at the noisy input,
lagged global deltas, and the same padding to ``tile * sub`` (the last
blocks' clipped window starts depend on the padded size, so ``sub`` is
kept although on the card it changes nothing else).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import DenoiseConfig
from ..device import exact_float32, resolve_device
from ..kernels import window as kw
from ..ops.morton import SortedCloud, morton_sort, unsort
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

    valid = torch.arange(n, device=dev) < nv
    centroid = torch.sum(torch.where(valid[None, :], pos0, 0.0), dim=1) / max(nv, 1)
    radius0 = torch.sqrt(torch.max(torch.where(
        valid, torch.sum((pos0 - centroid[:, None]) ** 2, dim=0), 0.0
    )))
    scal = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    for ci in range(len(needs_delta)):
        scal[1 + ci, 0] = radius0
        scal[4 + ci, 0:3] = centroid

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
    signature parity and unused: K0 always runs the counting search.
    Nothing is copied to the host between iterations.
    """
    iters = cfg.iterations if iterations is None else iterations
    if iters < 1:
        raise ValueError("denoise_hybrid needs at least one iteration")
    st = prologue(points, normals, cfg, strategy, num_valid, tile, window,
                  threshold_slack, sub, device)
    pack, scal, lay, win = st.pack, st.scal, st.lay, st.win
    t6 = kw.k1(pack, win, cfg.angle) if lagged_nvt1 else None
    cls = None
    for _ in range(iters):
        if not lagged_nvt1:
            t6 = kw.k1(pack, win, cfg.angle)
        pack2 = hs.vu_stage(t6, pack, cfg)
        k2out = kw.k2(pack2, scal, win, cfg.angle, strategy, len(st.needs_delta))
        pack, scal, cls = hs.update_stage(
            k2out, pack2, st.d_thr, cfg, strategy, st.needs_delta, lay, win.nv
        )
        if lagged_nvt1:
            # K2's filtered-NVT rows of the post-VU normals are the next
            # iteration's K1 output (the reference's lagged_nvt1).
            t6 = k2out[lay["t6"] : lay["t6"] + 6]

    idx, n_in = st.sorted.orig_idx, st.n_in
    out_pos = unsort(pack[0:3].T, idx)[:n_in]
    out_nrm = unsort(pack[3:6].T, idx)[:n_in]
    out_cls = unsort(cls.to(torch.int32)[:, None], idx)[:n_in, 0]
    return out_pos, out_nrm, out_cls
