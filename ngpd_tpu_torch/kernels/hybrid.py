"""The hybrid engine's per-point stages as CUDA kernels: wrappers over
``csrc/hybrid_vu.cu`` and ``csrc/hybrid_update.cu``.

Their plain versions are ``core/hybrid_stages.py::vu_stage`` and
``::update_stage`` (the reference's ``_xla_vu_stage`` and
``_xla_update_stage``). A wrapper given CPU tensors runs the plain
function; given CUDA tensors it launches its kernel on the current stream
and adds one to ``LAUNCHES[name]``; anything else raises. There is no
fallback from the kernel to the plain function.

The update kernel writes the next lag state as per-block partials in pass
BD's ``parts`` layout (5 nd, ceil(n / THREADS)), which
``kernels/passes.py::lag_scal`` reduces on the card: the same state as
``update_stage``'s, its centres summed per block, then over the blocks.
"""

from __future__ import annotations

import torch

from ..config import DenoiseConfig
from ..core import hybrid_stages as hs
from . import passes as kp
from . import window as kw

LAUNCHES = {"hybrid_vu": 0, "hybrid_update": 0}
THREADS = 256  # points a block of hybrid_update (UPDATE_THREADS): one column of parts
SLIM_ROWS = 8
_K2_ROWS = ("t6", "s6", "b_nv", "sv", "q18", "flat", "new", "deg", "maxd")


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(**operands) -> bool:
    """Validate ``name=(tensor, rows)`` operands of one point count: 2-D
    float32 with at least ``rows`` rows, on one device; True when that is
    a CUDA device, where each row must also be contiguous."""
    dev, n = None, None
    for name, (x, rows) in operands.items():
        if x.dtype != torch.float32 or x.dim() != 2:
            raise TypeError(f"{name} must be a 2-D float32 tensor, got {x.dtype} "
                            f"{tuple(x.shape)}")
        if x.shape[0] < rows or (n is not None and x.shape[1] != n):
            raise ValueError(f"{name} shape {tuple(x.shape)}: needs {rows} rows of "
                             f"{n if n is not None else x.shape[1]} points")
        if dev is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the other operands on {dev}")
        dev, n = x.device, x.shape[1]
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"the hybrid stage kernels run on cuda or cpu, not {dev}")
    for name, (x, _) in operands.items():
        if x.stride(1) != 1:
            raise ValueError(f"{name} must have contiguous rows")
    return True


def vu_stage(t6: torch.Tensor, pack: torch.Tensor, cfg: DenoiseConfig) -> torch.Tensor:
    """The post-VU pack [p, f, rk_feat, rk_step] (8, N) from the filtered-NVT
    rows ``t6`` (rows 0-5 used: K1's output, or K2's t6 rows) and the slim
    pack (8, N)."""
    if not _on_cuda(t6=(t6, 6), pack=(pack, SLIM_ROWS)):
        return hs.vu_stage(t6, pack, cfg)
    if tuple(pack.shape) != (SLIM_ROWS, pack.shape[1]) or not pack.is_contiguous():
        raise ValueError(f"pack must be a contiguous (8, N) slim pack, got "
                         f"{tuple(pack.shape)}")
    out = torch.empty_like(pack)
    kw.launch("hybrid_vu", LAUNCHES, t6.data_ptr(), t6.stride(0), pack.data_ptr(),
              out.data_ptr(), pack.shape[1], float(cfg.vu_tau), float(cfg.vu_damping))
    return out


def update_stage(k2: torch.Tensor, gq2: torch.Tensor, d_thr: torch.Tensor,
                 cfg: DenoiseConfig, strategy, needs_delta, lay: dict, nv: int):
    """(next slim pack (8, N), scal (8, 128), classes (N,) as floats) from
    K2's output ``k2`` (rows in ``lay`` order), the post-VU pack ``gq2`` and
    the 0-dim ``d_thr``."""
    if not _on_cuda(k2=(k2, lay["_total"]), gq2=(gq2, SLIM_ROWS)):
        return hs.update_stage(k2, gq2, d_thr, cfg, strategy, needs_delta, lay, nv)
    pack, cls, parts = update_kernel(k2, gq2, d_thr, cfg, strategy, needs_delta, lay, nv)
    return pack, kp.lag_scal(d_thr, parts), cls


def update_kernel(k2: torch.Tensor, gq2: torch.Tensor, d_thr: torch.Tensor,
                  cfg: DenoiseConfig, strategy, needs_delta, lay: dict, nv: int):
    """The update kernel's own outputs on CUDA operands: (next slim pack,
    classes, the lag state's partials (5 nd, ceil(N / THREADS)))."""
    needs_delta = tuple(needs_delta)
    dc = kp._delta_classes(needs_delta)
    step_args = kp._step_args(strategy, needs_delta, cfg)  # kinds, alphas, slots
    n = gq2.shape[1]
    if tuple(gq2.shape) != (SLIM_ROWS, n) or not gq2.is_contiguous() \
            or not k2.is_contiguous():
        raise ValueError("k2 and gq2 must be contiguous, gq2 an (8, N) pack")
    if not (isinstance(d_thr, torch.Tensor) and d_thr.numel() == 1
            and d_thr.dtype == torch.float32 and d_thr.device == gq2.device):
        raise ValueError("d_thr must be one float32 on the packs' device")
    if not 0 <= nv <= n:
        raise ValueError(f"nv must lie in [0, {n}], got {nv}")
    groups = {"edge": "q18", "flat": "flat", "new": "new"}
    if any(s in groups and groups[s] not in lay for s in strategy):
        raise ValueError(f"the layout {sorted(lay)} lacks rows of the strategy {strategy}")
    nd = len(needs_delta)
    rows = tuple(int(lay.get(name, -1)) for name in _K2_ROWS)
    pack = torch.empty_like(gq2)
    cls = torch.empty(n, dtype=torch.float32, device=gq2.device)
    parts = torch.empty((5 * nd, -(-n // THREADS)), dtype=torch.float32, device=gq2.device)
    kw.launch("hybrid_update", LAUNCHES, k2.data_ptr(), gq2.data_ptr(),
              d_thr.data_ptr(), pack.data_ptr(), cls.data_ptr(), parts.data_ptr(), n,
              int(nv), float(cfg.class_scale), *step_args[0:6], nd, *dc, *rows)
    return pack, cls, parts
