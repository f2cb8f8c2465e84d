"""Guarded batched 3x3 linear solves (torch).

The closed-form adjugate/determinant rule of ``ngpd_tpu/ops/solve3.py``
with the same relative-determinant guard (``rcond=1e-7``): rows whose
matrix is (near-)singular keep the fallback.
"""

from __future__ import annotations

import torch


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
