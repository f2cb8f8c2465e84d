"""Nearest neighbours (torch): chunked brute-force 1-NN.

``nn_distances`` is the primitive behind the Chamfer-family metrics, as
``ngpd_tpu/ops/knn.py::nn_distances``. Squared distances are float32
``|q|^2 + |p|^2 - 2 q.p`` with the product at full float32 precision (no
TF32), clamped at 0. The general ``(N, k)`` kNN is a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import exact_float32


def nn_distances(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    num_valid_b: Optional[int] = None,
    query_tile: int = 4096,
    point_tile: int = 65536,
):
    """1-NN squared distance from each point of ``a`` into cloud ``b``.

    Returns ``(sqdist (Qa,), idx (Qa,) int64)``; rows of ``b`` at or past
    ``num_valid_b`` are ignored. Work is chunked to (query_tile,
    point_tile) blocks on ``a``'s device.
    """
    exact_float32()
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32).to(a.device)
    if num_valid_b is not None:
        b = b[: int(num_valid_b)]
    b2 = torch.sum(b * b, dim=1)
    best_d = torch.empty(a.shape[0], dtype=torch.float32, device=a.device)
    best_i = torch.empty(a.shape[0], dtype=torch.int64, device=a.device)
    for q0 in range(0, a.shape[0], query_tile):
        q = a[q0 : q0 + query_tile]
        q2 = torch.sum(q * q, dim=1, keepdim=True)
        bd = torch.full((q.shape[0],), float("inf"), device=a.device)
        bi = torch.zeros((q.shape[0],), dtype=torch.int64, device=a.device)
        for p0 in range(0, b.shape[0], point_tile):
            p = b[p0 : p0 + point_tile]
            d = torch.clamp(q2 + b2[p0 : p0 + point_tile][None, :] - 2.0 * (q @ p.T), min=0.0)
            dmin, imin = torch.min(d, dim=1)
            better = dmin < bd
            bd = torch.where(better, dmin, bd)
            bi = torch.where(better, imin + p0, bi)
        best_d[q0 : q0 + query_tile] = bd
        best_i[q0 : q0 + query_tile] = bi
    return best_d, best_i
