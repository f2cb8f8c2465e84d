"""Per-point stages of the hybrid engine, plain torch over (N,) rows.

These are ``ngpd_tpu/core/pallas_fused.py``'s ``_xla_vu_stage`` and
``_xla_update_stage`` with their component helpers and pack layouts: the
elementwise math between the window kernels (closed-form eigh, the VU
filter, guarded 3x3 solves, class dispatch and the lagged-delta state).
They are the plain versions of the two stage kernels
(``kernels/hybrid.py``): the CPU runs them, the card the kernels.

Layouts, kept from the reference so the tests compare like with like:
  slim pack (8, N): [p(3), n(3), rk_feat, rk_step]
  scal (8, 128):    row 0 col 0 d_thr | rows 1+ci col 0 delta of the
                    ci-th class in ``needs_delta`` | rows 4+ci cols 0-2
                    that class's centre
  K2 output:        row offsets from ``kernels.window.k2_layout``
"""

from __future__ import annotations

import torch

from ..config import DenoiseConfig
from ..ops.eigh3 import eigh3x3_components, vu_filter_components
from ..ops.solve3 import solve3x3_components
from ..ops.steps import (
    classes_c, clamp_step, edge_solve, flat_step, select_by_class, srow,
    three_term_solve,
)


def build_pack_slim(pos: torch.Tensor, nrm: torch.Tensor) -> torch.Tensor:
    """(3, N) positions and normals -> the (8, N) slim pack with zero
    threshold rows."""
    zeros = torch.zeros((2, pos.shape[1]), dtype=pos.dtype, device=pos.device)
    return torch.cat([pos, nrm, zeros], dim=0).contiguous()


def set_rk_slim(pk: torch.Tensor, rk_feat, rk_step) -> torch.Tensor:
    out = pk.clone()
    out[6] = rk_feat
    out[7] = rk_step
    return out


def needs_delta_of(strategy) -> tuple:
    """Classes whose step needs a lagged global delta (flat and new)."""
    return tuple(c for c in range(3) if strategy[c] in ("flat", "new"))


def vu_stage(t6: torch.Tensor, gq: torch.Tensor, cfg: DenoiseConfig) -> torch.Tensor:
    """VU smoothing and the post-VU pack [p, f, rkf, rks].

    t6: (>=6, N) filtered-NVT sums; gq: (8, N) slim pack."""
    n_i = (gq[3], gq[4], gq[5])
    f = vu_filter_components(
        (t6[0], t6[1], t6[2], t6[3], t6[4], t6[5]),
        n_i, cfg.vu_tau, cfg.vu_damping,
    )
    return torch.cat(
        [gq[0:3], f[0][None], f[1][None], f[2][None], gq[6:8]], dim=0
    ).contiguous()


def update_stage(
    k2: torch.Tensor,
    gq2: torch.Tensor,
    d_thr: torch.Tensor,
    cfg: DenoiseConfig,
    strategy,
    needs_delta,
    lay: dict,
    nv: int,
):
    """Classify, solve, dispatch by class and build the next pack and the
    next lag state. gq2 is the post-VU pack [p, f, rkf, rks].

    Returns (next pack (8, N), scal (8, 128), classes (N,) as floats)."""
    n = gq2.shape[1]
    p_i = (gq2[0], gq2[1], gq2[2])
    n_i = (gq2[3], gq2[4], gq2[5])
    alphas = cfg.alphas

    t6 = k2[lay["t6"] : lay["t6"] + 6]
    w, v = eigh3x3_components(t6[0], t6[1], t6[2], t6[3], t6[4], t6[5])
    cls = classes_c(w, cfg.class_scale)
    y = v[0]

    s6 = tuple(k2[lay["s6"] + r] for r in range(6))
    b_nv = tuple(k2[lay["b_nv"] + r] for r in range(3))
    sv = tuple(k2[lay["sv"] + r] for r in range(3))
    deg = k2[lay["deg"]]

    results = {}
    for cid in range(3):
        name = strategy[cid]
        alpha = alphas[cid]
        if name == "flat":
            results[cid] = flat_step(k2[lay["flat"]], k2[lay["flat"] + 1], n_i,
                                     p_i, alpha, d_thr)
        elif name == "edge":
            q = k2[lay["q18"] : lay["q18"] + 18]
            pidx = {(0, 0): 0, (0, 1): 1, (0, 2): 2,
                    (1, 1): 3, (1, 2): 4, (2, 2): 5}
            pidx.update({(a, c): i for (c, a), i in list(pidx.items())})
            q_yy = tuple(
                sum(
                    q[pidx[(c, a)] * 3 + b] * y[a] * y[b]
                    for a in range(3)
                    for b in range(3)
                )
                for c in range(3)
            )
            results[cid] = clamp_step(edge_solve(y, s6, b_nv, q_yy, deg, p_i),
                                      p_i, alpha, d_thr)
        elif name == "corner":
            opt, _ = solve3x3_components(srow(s6), b_nv, p_i)
            results[cid] = clamp_step(opt, p_i, alpha, d_thr)
        elif name == "feature":
            results[cid] = clamp_step(three_term_solve(n_i, p_i, deg, s6, b_nv, sv),
                                      p_i, alpha, d_thr)
        elif name == "new":
            s6w = tuple(k2[lay["new"] + r] for r in range(6))
            b_nvw = tuple(k2[lay["new"] + 6 + r] for r in range(3))
            svw = tuple(k2[lay["new"] + 9 + r] for r in range(3))
            results[cid] = clamp_step(three_term_solve(n_i, p_i, deg, s6w, b_nvw, svw),
                                      p_i, alpha, d_thr)
        elif name == "dummy":
            results[cid] = p_i
        else:
            raise ValueError(name)

    new_p = select_by_class(cls, results)
    valid = torch.arange(n, device=gq2.device) < nv
    new_p = tuple(torch.where(valid, np_, p0) for np_, p0 in zip(new_p, p_i))

    # Next-iteration lag state, built on the device (no host sync).
    scal = torch.zeros((8, 128), dtype=gq2.dtype, device=gq2.device)
    scal[0, 0] = d_thr
    jp = k2[lay["jp"] : lay["jp"] + 3]
    for ci, c in enumerate(needs_delta):
        mask_c = ((cls == float(c)) & valid).to(gq2.dtype)
        cnt = torch.clamp(torch.sum(deg * mask_c), min=1.0)
        scal[4 + ci, 0:3] = torch.sum(jp * mask_c[None, :], dim=1) / cnt
        scal[1 + ci, 0] = torch.sqrt(
            torch.clamp(torch.max(k2[lay["maxd"] + ci] * mask_c), min=0.0)
        )

    gq_n = torch.cat(
        [new_p[0][None], new_p[1][None], new_p[2][None],
         n_i[0][None], n_i[1][None], n_i[2][None], gq2[6:8]],
        dim=0,
    ).contiguous()
    return gq_n, scal, cls
