"""Dense fixed-k neighbourhoods (torch), as ``ngpd_tpu/ops/neighbors.py``.

A neighbourhood is a dense ``(Q, K)`` int64 index tensor plus a ``(Q, K)``
bool validity mask: gathers are ``values[idx]`` of shape ``(Q, K, ...)``
and the reference's scatter reductions are masked reductions over axis 1.
Indices are int64 (torch's index type) where the reference keeps int32;
``Neighborhood.from_numpy`` takes either, so the tests hand both packages
the same neighbourhoods.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Neighborhood(NamedTuple):
    """A dense k-neighbourhood of Q query points.

    idx: (Q, K) int64 neighbour indices into the source array; invalid
    slots carry an arbitrary in-range index and are ignored via ``mask``.
    mask: (Q, K) bool, True where the slot holds a real neighbour.
    """

    idx: torch.Tensor
    mask: torch.Tensor

    @classmethod
    def from_numpy(cls, idx, mask, device="cpu") -> "Neighborhood":
        """Neighbourhood state made elsewhere (numpy, any integer type),
        moved onto ``device``."""
        return cls(
            torch.as_tensor(np.asarray(idx).astype(np.int64), device=device),
            torch.as_tensor(np.asarray(mask).astype(bool), device=device),
        )

    @property
    def num_queries(self) -> int:
        return self.idx.shape[0]

    @property
    def k(self) -> int:
        return self.idx.shape[1]

    def gather(self, values: torch.Tensor) -> torch.Tensor:
        """values: (N, ...) -> (Q, K, ...)."""
        return values[self.idx]

    def degree(self) -> torch.Tensor:
        """(Q,) float32, the number of valid neighbours per query."""
        return torch.sum(self.mask, dim=1).to(torch.float32)

    def _blank(self, values: torch.Tensor) -> torch.Tensor:
        """The mask broadcast against values of shape (Q, K, ...)."""
        m = self.mask
        return m.reshape(m.shape + (1,) * (values.dim() - 2))

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """Masked sum over the neighbour axis: (Q, K, ...) -> (Q, ...)."""
        return torch.sum(torch.where(self._blank(values), values, 0.0), dim=1)

    def mean(self, values: torch.Tensor) -> torch.Tensor:
        """Masked mean over the neighbour axis (0 where degree == 0)."""
        deg = self.degree()
        deg = deg.reshape(deg.shape + (1,) * (values.dim() - 2))
        return self.sum(values) / torch.clamp(deg, min=1.0)

    def max(self, values: torch.Tensor) -> torch.Tensor:
        """Masked max over the neighbour axis (masked slots at -inf)."""
        return torch.amax(
            torch.where(self._blank(values), values, float("-inf")), dim=1
        )

    def weighted_sum(self, weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        """sum_j w_ij v_j with the mask applied to the weights.
        weights: (Q, K); values: (Q, K, ...)."""
        w = torch.where(self.mask, weights, 0.0)
        w = w.reshape(w.shape + (1,) * (values.dim() - 2))
        return torch.sum(w * values, dim=1)

    def and_mask(self, extra: torch.Tensor) -> "Neighborhood":
        """Refine validity with an additional (Q, K) boolean mask."""
        return Neighborhood(self.idx, self.mask & extra)

    def filter_rows(self, rows: torch.Tensor) -> "Neighborhood":
        """Subselect query rows (off the hot path)."""
        return Neighborhood(self.idx[rows], self.mask[rows])


def outer3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched outer product a b^T: (..., 3) -> (..., 3, 3)."""
    return a[..., :, None] * b[..., None, :]


def matvec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3) -> (..., 3)."""
    return torch.sum(m * v[..., None, :], dim=-1)


def normalize(v: torch.Tensor, axis: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Safe L2 normalisation along ``axis`` (the reference's name for the
    dimension), torch.nn.functional.normalize semantics."""
    n = torch.linalg.norm(v, dim=axis, keepdim=True)
    return v / torch.clamp(n, min=eps)


def neighborhood_triangles(nbh: Neighborhood):
    """Triangles (i, a, b) whose three edges all exist in the graph: for
    every point i and every pair (a, b) of its neighbours, a face iff b is
    also a neighbour of a; each face kept once (i < a < b).

    Returns (tri (N*k*k, 3) int64, valid (N*k*k,) bool), padded; compact
    with ``tri[valid]``.
    """
    idx = nbh.idx
    n, k = idx.shape
    safe = torch.where(nbh.mask, idx, n)
    non = torch.where(nbh.mask[idx] & nbh.mask[:, :, None], safe[idx], n + 1)
    mutual = torch.any(non[:, :, None, :] == safe[:, None, :, None], dim=-1)
    i = torch.arange(n, dtype=idx.dtype, device=idx.device)[:, None, None]
    ordered = (i < safe[:, :, None]) & (safe[:, :, None] < safe[:, None, :])
    ok = mutual & ordered & nbh.mask[:, :, None] & nbh.mask[:, None, :]
    tri = torch.stack(
        [
            i.expand(n, k, k),
            idx[:, :, None].expand(n, k, k),
            idx[:, None, :].expand(n, k, k),
        ],
        dim=-1,
    ).reshape(-1, 3)
    return tri, ok.reshape(-1)
