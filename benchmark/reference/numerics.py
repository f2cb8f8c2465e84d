"""Plain closed-form numerics shared by the references: the batched 3x3
symmetric eigensolver (D. Eberly, "A Robust Eigensolver for 3x3 Symmetric
Matrices": trigonometric roots, cross-product and deflation eigenvectors),
the VU normal filter in its projector form, the guarded 3x3 solves
(adjugate over determinant, relative-determinant guard 1e-7), the
classifier and the class steps of the normal-voting denoise
(Processor.py / Denoiser.py of the thesis code), elementwise over tensors
of any shape, eigenvalues ascending.

``contract`` is every product over a neighbour axis or a window that the
references compute. Inside ``at_tf32(True)`` it rounds both operands to
TF32 (10 mantissa bits, round to nearest even) and sums in float32, as a
TF32 tensor core does: that is the lower-precision control of a float32
configuration whose products run with TF32 off.
"""

from __future__ import annotations

import contextlib
import math

import torch

_TF32 = [False]


@contextlib.contextmanager
def at_tf32(on: bool):
    """Every ``contract`` inside the block at TF32 where ``on``."""
    before = _TF32[0]
    _TF32[0] = bool(on)
    try:
        yield
    finally:
        _TF32[0] = before


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    out = (bits + 0x0FFF + lsb) & ~0x1FFF
    return torch.where(torch.isfinite(x), out.view(torch.float32), x)


def contract(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *ops)``, its operands at TF32 in the control."""
    if _TF32[0]:
        ops = tuple(round_tf32(o) for o in ops)
    return torch.einsum(eq, *ops)

_EPS = 1e-12


def _cross_c(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _dot_c(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _norm2_c(a):
    return _dot_c(a, a)


def _normalize_c(a, eps=_EPS):
    inv = 1.0 / torch.sqrt(torch.clamp(_norm2_c(a), min=eps))
    return (a[0] * inv, a[1] * inv, a[2] * inv)


def _select_c(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def _evec_from_cross_c(rows, lam):
    """Eigenvector for ``lam`` from the largest cross product of rows of
    (B - lam I)."""
    r0 = (rows[0][0] - lam, rows[0][1], rows[0][2])
    r1 = (rows[1][0], rows[1][1] - lam, rows[1][2])
    r2 = (rows[2][0], rows[2][1], rows[2][2] - lam)
    c01, c02, c12 = _cross_c(r0, r1), _cross_c(r0, r2), _cross_c(r1, r2)
    n01, n02, n12 = _norm2_c(c01), _norm2_c(c02), _norm2_c(c12)
    best12 = _select_c(n12 >= n02, c12, c02)
    nbest12 = torch.maximum(n12, n02)
    v = _select_c(n01 >= nbest12, c01, best12)
    nv = torch.maximum(n01, nbest12)
    v = _normalize_c(v)
    one = torch.ones_like(lam)
    zero = torch.zeros_like(lam)
    return _select_c(nv > _EPS, v, (one, zero, zero))


def _orthobasis_c(w):
    swap = torch.abs(w[0]) > torch.abs(w[1])
    inv_xz = 1.0 / torch.sqrt(torch.clamp(w[0] * w[0] + w[2] * w[2], min=_EPS))
    inv_yz = 1.0 / torch.sqrt(torch.clamp(w[1] * w[1] + w[2] * w[2], min=_EPS))
    zero = torch.zeros_like(w[0])
    u_a = (-w[2] * inv_xz, zero, w[0] * inv_xz)
    u_b = (zero, w[2] * inv_yz, -w[1] * inv_yz)
    u = _select_c(swap, u_a, u_b)
    v = _cross_c(w, u)
    return u, v


def _matvec_c(rows, x):
    return tuple(_dot_c(r, x) for r in rows)


def _evec_deflated_c(rows, lam, w):
    u, v = _orthobasis_c(w)
    bu = _matvec_c(rows, u)
    bv = _matvec_c(rows, v)
    m00 = _dot_c(u, bu) - lam
    m01 = _dot_c(u, bv)
    m11 = _dot_c(v, bv) - lam
    use0 = torch.abs(m00) >= torch.abs(m11)
    c0 = torch.where(use0, m01, m11)
    c1 = torch.where(use0, -m00, -m01)
    norm = torch.sqrt(c0 * c0 + c1 * c1)
    ok = norm > _EPS
    c0 = torch.where(ok, c0 / torch.clamp(norm, min=_EPS), torch.ones_like(c0))
    c1 = torch.where(ok, c1 / torch.clamp(norm, min=_EPS), torch.zeros_like(c1))
    return tuple(c0 * ux + c1 * vx for ux, vx in zip(u, v))


def _roots(a00, a01, a02, a11, a12, a22, acos_fn=torch.acos):
    """Scaled trigonometric roots shared by both entry points."""
    scale = torch.maximum(
        torch.maximum(
            torch.maximum(torch.abs(a00), torch.abs(a11)),
            torch.maximum(torch.abs(a22), torch.abs(a01)),
        ),
        torch.maximum(torch.abs(a02), torch.abs(a12)),
    )
    safe = torch.clamp(scale, min=_EPS)
    b00, b01, b02 = a00 / safe, a01 / safe, a02 / safe
    b11, b12, b22 = a11 / safe, a12 / safe, a22 / safe
    q = (b00 + b11 + b22) / 3.0
    d00, d11, d22 = b00 - q, b11 - q, b22 - q
    p1 = b01 * b01 + b02 * b02 + b12 * b12
    p2 = d00 * d00 + d11 * d11 + d22 * d22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    safe_p = torch.clamp(p, min=_EPS)
    c00, c11, c22 = d00 / safe_p, d11 / safe_p, d22 / safe_p
    c01, c02, c12 = b01 / safe_p, b02 / safe_p, b12 / safe_p
    det_c = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    r = torch.clamp(det_c / 2.0, -1.0, 1.0)
    phi = acos_fn(r) / 3.0
    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_hi - lam_lo
    rows = ((b00, b01, b02), (b01, b11, b12), (b02, b12, b22))
    return scale, safe, rows, q, p, (lam_lo, lam_mid, lam_hi)


def _unscale(scale, safe, lams):
    nonzero = scale > 0
    return tuple(
        torch.where(nonzero, lam * safe, torch.zeros_like(lam)) for lam in lams
    )


def eigvals3x3_components(a00, a01, a02, a11, a12, a22, acos_fn=torch.acos):
    """Eigenvalues only, ascending."""
    scale, safe, _, _, _, lams = _roots(a00, a01, a02, a11, a12, a22, acos_fn)
    return _unscale(scale, safe, lams)


def vu_filter_components(t6, n, tau, damping, acos_fn=torch.acos):
    """VU-smoothed normals straight from the voting tensor, in the
    projector form ``normalize(damping*n + P n)`` with ``P`` the sum of
    the eigenprojectors whose eigenvalue exceeds ``tau`` (see
    ``ngpd_tpu/ops/eigh3.py::vu_filter_components``)."""
    a00, a01, a02, a11, a12, a22 = t6
    lam0, lam1, lam2 = eigvals3x3_components(a00, a01, a02, a11, a12, a22,
                                             acos_fn)
    u = (
        a00 * n[0] + a01 * n[1] + a02 * n[2],
        a01 * n[0] + a11 * n[1] + a12 * n[2],
        a02 * n[0] + a12 * n[1] + a22 * n[2],
    )
    z = (
        a00 * u[0] + a01 * u[1] + a02 * u[2],
        a01 * u[0] + a11 * u[1] + a12 * u[2],
        a02 * u[0] + a12 * u[1] + a22 * u[2],
    )

    def proj(lam_a, lam_b, lam_c):
        den = (lam_a - lam_b) * (lam_a - lam_c)
        inv = den / torch.clamp(den * den, min=_EPS)
        return tuple(
            (z[c] - (lam_b + lam_c) * u[c] + lam_b * lam_c * n[c]) * inv
            for c in range(3)
        )

    k = (
        (lam0 > tau).to(lam0.dtype)
        + (lam1 > tau).to(lam0.dtype)
        + (lam2 > tau).to(lam0.dtype)
    )
    p_hi = proj(lam2, lam0, lam1)
    p_lo = proj(lam0, lam1, lam2)
    pn = tuple(
        torch.where(
            k == 1.0, p_hi[c],
            torch.where(
                k == 2.0, n[c] - p_lo[c],
                torch.where(k == 3.0, n[c], torch.zeros_like(n[c])),
            ),
        )
        for c in range(3)
    )
    acc = tuple(damping * n[c] + pn[c] for c in range(3))
    return _normalize_c(acc)


def eigh3x3_components(a00, a01, a02, a11, a12, a22, acos_fn=torch.acos):
    """Eigendecomposition from the six unique entries (elementwise).

    Returns ``(w, v)``: ``w = (lam0, lam1, lam2)`` ascending and ``v`` a
    tuple of three eigenvector component triples, ``v[i]`` pairing with
    ``w[i]``. ``acos_fn``: ``ops.fastmath.acos_poly`` reproduces the pass
    kernels, which run the eigensolver with the polynomial.
    """
    scale, safe, rows, q, p, (lam_lo, lam_mid, lam_hi) = _roots(
        a00, a01, a02, a11, a12, a22, acos_fn
    )
    from_hi = (lam_hi - lam_mid) >= (lam_mid - lam_lo)
    v_hi_first = _evec_from_cross_c(rows, lam_hi)
    v_lo_first = _evec_from_cross_c(rows, lam_lo)
    v_first = _select_c(from_hi, v_hi_first, v_lo_first)
    v_mid = _evec_deflated_c(rows, lam_mid, v_first)
    v_third = _cross_c(v_first, v_mid)
    v_lo = _select_c(from_hi, v_third, v_first)
    v_hi = _select_c(from_hi, v_first, v_third)

    # Isotropic / zero matrices: identity eigenvectors.
    iso = p < 1e-6
    one = torch.ones_like(q)
    zero = torch.zeros_like(q)
    v_lo = _select_c(iso, (one, zero, zero), v_lo)
    v_mid = _select_c(iso, (zero, one, zero), v_mid)
    v_hi = _select_c(iso, (zero, zero, one), v_hi)
    w = _unscale(scale, safe, (lam_lo, lam_mid, lam_hi))
    return w, (v_lo, v_mid, v_hi)


def eigh3x3(A: torch.Tensor):
    """Batched eigendecomposition of symmetric (..., 3, 3) matrices:
    eigenvalues (..., 3) ascending and eigenvectors (..., 3, 3) as
    columns, like ``torch.linalg.eigh`` but closed-form."""
    A = 0.5 * (A + A.transpose(-1, -2))
    w, v = eigh3x3_components(
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2],
    )
    eigval = torch.stack(w, dim=-1)
    eigvec = torch.stack([torch.stack(vi, dim=-1) for vi in v], dim=-1)
    return eigval, eigvec

def _entries(A):
    return (A[..., 0, 0], A[..., 0, 1], A[..., 0, 2], A[..., 1, 0], A[..., 1, 1],
            A[..., 1, 2], A[..., 2, 0], A[..., 2, 1], A[..., 2, 2])


def det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3), by the first row's cofactors."""
    a, b, c, d, e, f, g, h, i = _entries(A)
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def adjugate3(A: torch.Tensor) -> torch.Tensor:
    """Adjugate (transposed cofactor matrix) of (..., 3, 3)."""
    a, b, c, d, e, f, g, h, i = _entries(A)
    return torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)


def solve3x3_components(rows, b, fallback, rcond: float = 1e-7):
    """rows: 3 row-triples of component tensors; b, fallback: component
    triples. Returns (x triple, ok mask)."""
    (a, bb, c), (d, e, f), (g, h, i) = rows
    det = a * (e * i - f * h) - bb * (d * i - f * g) + c * (d * h - e * g)
    scale = torch.abs(a)
    for v in (bb, c, d, e, f, g, h, i):
        scale = torch.maximum(scale, torch.abs(v))
    ok = torch.abs(det) > rcond * torch.clamp(scale, min=1e-30) ** 3
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    adj = (
        (e * i - f * h, c * h - bb * i, bb * f - c * e),
        (f * g - d * i, a * i - c * g, c * d - a * f),
        (d * h - e * g, bb * g - a * h, a * e - bb * d),
    )
    x = tuple(
        (r[0] * b[0] + r[1] * b[1] + r[2] * b[2]) * inv_det for r in adj
    )
    x = tuple(torch.where(ok, xi, fi) for xi, fi in zip(x, fallback))
    return x, ok


def solve3x3_guarded(A, b, fallback, rcond: float = 1e-7):
    """Solve ``A x = b`` per batch row; (near-)singular rows get
    ``fallback``. A: (..., 3, 3); b, fallback: (..., 3).
    Returns (x (..., 3), ok (...,))."""
    det = det3(A)
    scale = torch.abs(A).amax(dim=(-2, -1))
    ok = torch.abs(det) > rcond * torch.clamp(scale, min=1e-30) ** 3
    ok = ok & torch.isfinite(det)
    x = torch.einsum("...ij,...j->...i", adjugate3(A), b) / torch.where(
        ok, det, torch.ones_like(det)
    )[..., None]
    x = torch.where(ok[..., None], x, fallback)
    return x, ok

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
