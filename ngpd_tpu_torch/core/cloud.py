"""Point-cloud container on tensors (the port of ``ngpd_tpu/core/cloud.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Sentinel coordinate for padding rows: far enough that padded points can
# never win a nearest-neighbour race against real geometry.
PAD_SENTINEL = 1e30


@dataclasses.dataclass
class PointCloud:
    """A (possibly padded) point cloud.

    Attributes:
      points: (N, 3) float32 positions. Rows >= num_valid are padding.
      normals: optional (N, 3) float32 unit normals.
      num_valid: count of real points (<= N).
    """

    points: torch.Tensor
    normals: Optional[torch.Tensor] = None
    num_valid: Optional[int] = None

    def __post_init__(self):
        assert self.points.ndim == 2 and self.points.shape[1] == 3, self.points.shape
        if self.normals is not None:
            assert self.normals.shape == self.points.shape
        if self.num_valid is None:
            self.num_valid = int(self.points.shape[0])

    def __len__(self) -> int:
        return int(self.num_valid)

    def has_normals(self) -> bool:
        return self.normals is not None

    def padded_to(self, multiple: int) -> "PointCloud":
        """Pad the point count up to a multiple; padding rows sit at
        PAD_SENTINEL, padding normals are zero."""
        n = self.points.shape[0]
        target = -(-n // multiple) * multiple
        if target == n:
            return self
        pad = target - n
        pts = torch.cat([self.points, self.points.new_full((pad, 3), PAD_SENTINEL)])
        nrm = (
            None
            if self.normals is None
            else torch.cat([self.normals, self.normals.new_zeros((pad, 3))])
        )
        return PointCloud(pts, nrm, num_valid=self.num_valid)

    def valid_points(self) -> np.ndarray:
        return self.points[: self.num_valid].cpu().numpy()

    def valid_normals(self) -> Optional[np.ndarray]:
        if self.normals is None:
            return None
        return self.normals[: self.num_valid].cpu().numpy()

    @classmethod
    def from_numpy(
        cls, v: np.ndarray, n: Optional[np.ndarray] = None
    ) -> "PointCloud":
        pts = torch.as_tensor(np.asarray(v, dtype=np.float32))
        nrm = None if n is None else torch.as_tensor(np.asarray(n, dtype=np.float32))
        return cls(pts, nrm)
