"""Per-point step math shared by both engines, plain torch over rows.

The classifier and the class-dispatched vertex updates of
``ngpd_tpu/core/pallas_fused.py`` (``_classes_c`` l.73, the steps of
``_xla_update_stage`` and of pass D l.402-560) on tuples of component
tensors of any one shape: the hybrid engine calls them on (N,) rows, the
four-pass engine's plain pass D on (blocks, tile) rows.
"""

from __future__ import annotations

import torch

from .solve3 import solve3x3_components

STEP_NAMES = ("flat", "edge", "corner", "feature", "new", "dummy")


def dot_c(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def norm_c(a):
    return torch.sqrt(torch.clamp(dot_c(a, a), min=0.0))


def classes_c(w, scale):
    """argmax of [scale*planarity, linearity, sphericity] as floats
    0./1./2., first maximum winning."""
    lam1, lam2, lam3 = w[2], w[1], w[0]
    safe = torch.where(torch.abs(lam1) > 1e-30, lam1, torch.full_like(lam1, 1e-30))
    plan = (lam1 - lam2) / safe * scale
    lin = (lam2 - lam3) / safe
    sph = lam3 / safe
    cls = torch.zeros_like(plan)
    best = plan
    cls = torch.where(lin > best, torch.ones_like(cls), cls)
    best = torch.maximum(best, lin)
    cls = torch.where(sph > best, torch.full_like(cls, 2.0), cls)
    return cls


def srow(t6):
    """The symmetric 3x3 matrix of six sums (00 01 02 11 12 22) as rows."""
    return ((t6[0], t6[1], t6[2]), (t6[1], t6[3], t6[4]), (t6[2], t6[4], t6[5]))


def clamp_step(opt, p_i, alpha, d_thr):
    """p + alpha (opt - p) where that step is shorter than d_thr, else p."""
    di = tuple((o - p) * alpha for o, p in zip(opt, p_i))
    ok = norm_c(di) < d_thr
    return tuple(torch.where(ok, p + dd, p) for p, dd in zip(p_i, di))


def flat_step(num, den, n_i, p_i, alpha, d_thr):
    """The bilateral flat step along n_i from its window sums; its clamp
    keeps a step of exactly d_thr (<=, unlike clamp_step)."""
    scalef = num / torch.clamp(den, min=1e-30) * alpha
    di = tuple(scalef * nc for nc in n_i)
    ok = norm_c(di) <= d_thr
    return tuple(torch.where(ok, p + dd, p) for p, dd in zip(p_i, di))


def three_term_solve(n_i, p_i, deg, s6w, b_nvw, svw):
    """The feature/new system (Denoiser.py:144-162); deg stays raw."""
    nio = (
        (n_i[0] * n_i[0], n_i[0] * n_i[1], n_i[0] * n_i[2]),
        (n_i[0] * n_i[1], n_i[1] * n_i[1], n_i[1] * n_i[2]),
        (n_i[0] * n_i[2], n_i[1] * n_i[2], n_i[2] * n_i[2]),
    )
    sr = srow(s6w)
    rows = tuple(
        tuple(
            (1.0 if a == b else 0.0) + nio[a][b] * (1.0 + deg) + sr[a][b]
            for b in range(3)
        )
        for a in range(3)
    )
    niv = tuple(dot_c(nio[a], p_i) for a in range(3))
    nisv = tuple(dot_c(nio[a], svw) for a in range(3))
    b = tuple(p_i[c] + niv[c] + nisv[c] + b_nvw[c] for c in range(3))
    opt, _ = solve3x3_components(rows, b, p_i)
    return opt


def edge_solve(y, s6, b_nv, q_yy, deg, p_i):
    """The edge system projected off the edge direction y; q_yy[c] is
    sum_j n_jc (n_j.y)(p_j.y) over the step mask."""
    sr = srow(s6)
    sy = tuple(dot_c(sr[a], y) for a in range(3))
    ysy = dot_c(sy, y)
    rows = tuple(
        tuple(
            sr[a][b] - y[a] * sy[b] - sy[a] * y[b]
            + ysy * y[a] * y[b] + deg * y[a] * y[b]
            for b in range(3)
        )
        for a in range(3)
    )
    z = tuple(b_nv[c] - q_yy[c] for c in range(3))
    yz = dot_c(y, z)
    yp = dot_c(y, p_i)
    b = tuple(z[c] - yz * y[c] + deg * yp * y[c] for c in range(3))
    opt, _ = solve3x3_components(rows, b, p_i)
    return opt


def select_by_class(cls, results):
    """Each point takes the step of its class (0./1./2.)."""
    return tuple(
        torch.where(cls == 0.0, results[0][c],
                    torch.where(cls == 1.0, results[1][c], results[2][c]))
        for c in range(3)
    )
