"""Polynomial arccos (torch), the one the pass kernels use.

``acos_poly`` is ``ngpd_tpu/ops/fastmath.py``'s Hastings 7-term
approximation (Abramowitz & Stegun 4.4.45, |error| <= 2e-8 over [-1, 1]),
with the same coefficients in the same Horner order, so that the plain
versions of the pass kernels round as the reference's kernels do. The
CUDA kernels carry the same polynomial (``kernels/csrc/passes_common.cuh``).
"""

from __future__ import annotations

import math

import torch

ACOS_COEFFS = (
    -0.0012624911,
    0.0066700901,
    -0.0170881256,
    0.0308918810,
    -0.0501743046,
    0.0889789874,
    -0.2145988016,
    1.5707963050,
)


def acos_poly(x: torch.Tensor) -> torch.Tensor:
    """Polynomial arccos, elementwise, in the tensor's float type."""
    xc = torch.clamp(x, -1.0, 1.0)
    ax = torch.abs(xc)
    p = torch.full_like(ax, ACOS_COEFFS[0])
    for c in ACOS_COEFFS[1:]:
        p = p * ax + c
    r = p * torch.sqrt(torch.clamp(1.0 - ax, min=0.0))
    return torch.where(xc < 0, math.pi - r, r)
