"""Morton (Z-order) spatial sorting (torch).

After the sort a point's geometric neighbours lie within a small index
window, so the window kernels read contiguous column spans. Codes are
built exactly as in ``ngpd_tpu/ops/morton.py``: 10 bits a coordinate, a
truncating float->int32 cast, padding rows coded ``2**30`` and clamped to
a finite far corner. Ties between equal codes are broken by original
row (a stable sort), which the JAX sort leaves unspecified.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

MORTON_BITS = 10  # 1024^3 grid; codes fit in 30 bits of an int32.


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so consecutive bits are 3 apart."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def valid_bounds(points: torch.Tensor, valid: torch.Tensor):
    """(points with invalid rows zeroed, per-axis min and max over the
    valid rows)."""
    v3 = valid[:, None]
    safe = torch.where(v3, points, torch.zeros_like(points))
    inf = torch.tensor(float("inf"), dtype=points.dtype, device=points.device)
    return safe, torch.where(v3, safe, inf).amin(dim=0), torch.where(v3, safe, -inf).amax(dim=0)


def morton_codes(points: torch.Tensor, num_valid: Optional[int] = None) -> torch.Tensor:
    """Z-order codes (int32) of (N, 3) points; padding rows get 2**30."""
    n = points.shape[0]
    nv = n if num_valid is None else int(num_valid)
    valid = torch.arange(n, device=points.device) < nv
    safe, mn, mx = valid_bounds(points, valid)
    return codes_in_box(safe, valid, mn, mx)


def codes_in_box(safe: torch.Tensor, valid: torch.Tensor, mn: torch.Tensor,
                 mx: torch.Tensor) -> torch.Tensor:
    """Z-order codes of ``safe`` quantised in the box [mn, mx]; invalid rows
    get 2**30."""
    # A tensor numerator: torch computes `scalar / tensor` as a reciprocal
    # times the scalar, which rounds differently and moves cells at the
    # truncation boundary.
    top = torch.full_like(mx, 2**MORTON_BITS - 1)
    scale = top / torch.clamp(mx - mn, min=1e-30)
    cell = torch.clamp(
        ((safe - mn) * scale).to(torch.int32), 0, 2**MORTON_BITS - 1
    )
    code = (
        _part1by2(cell[:, 0])
        | (_part1by2(cell[:, 1]) << 1)
        | (_part1by2(cell[:, 2]) << 2)
    )
    return torch.where(valid, code, torch.full_like(code, 2**30))


class SortedCloud(NamedTuple):
    """Point data in Morton order; ``orig_idx`` maps sorted row ->
    original row, padding rows sit at the end."""

    pos: torch.Tensor  # (N, 3)
    nrm: torch.Tensor  # (N, 3)
    orig_idx: torch.Tensor  # (N,) int64
    num_valid: int


def morton_sort(
    points: torch.Tensor,
    normals: torch.Tensor,
    num_valid: Optional[int] = None,
) -> SortedCloud:
    n = points.shape[0]
    nv = n if num_valid is None else int(num_valid)
    code = morton_codes(points, nv)
    valid = (torch.arange(n, device=points.device) < nv)[:, None]
    # Padding coords go to a finite corner so no inf/nan reaches the
    # distance sums (they stay excluded by index masks).
    ninf = torch.tensor(-float("inf"), dtype=points.dtype, device=points.device)
    far = torch.where(valid, points, ninf).amax(dim=0) + 1.0
    pts = torch.where(valid, points, far)
    _, order = torch.sort(code, stable=True)
    return SortedCloud(
        pos=pts[order], nrm=normals[order], orig_idx=order, num_valid=nv
    )


def unsort(values: torch.Tensor, orig_idx: torch.Tensor) -> torch.Tensor:
    """Scatter sorted-order rows back to original order."""
    out = torch.zeros_like(values)
    out[orig_idx] = values
    return out
