"""Geometry metrics (torch), as ``ngpd_tpu/ops/metrics.py``.

  * chamfer_distance: bi-directional squared NN distances, concatenated
    (callers take ``.mean()``);
  * single_chamfer_distance: the one-sided term;
  * hausdorff_distance: NN (non-squared) distances both ways;
  * paper_distance: for each noisy point, its NN distance to the GT over
    the GT bounding-box diagonal;
  * mean_angular_error / msae: mean angle in degrees and RMS angle in
    radians between two normal fields;
  * average_edge_length / pointcloud_radius.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .knn import nn_distances
from .neighbors import Neighborhood


def chamfer_distance(pos0: torch.Tensor, pos1: torch.Tensor) -> torch.Tensor:
    d0, _ = nn_distances(pos0, pos1)
    d1, _ = nn_distances(pos1, pos0)
    return torch.cat([d0, d1], dim=0)


def single_chamfer_distance(pos0: torch.Tensor, pos1: torch.Tensor) -> torch.Tensor:
    d0, _ = nn_distances(pos0, pos1)
    return d0


def hausdorff_distance(pos0: torch.Tensor, pos1: torch.Tensor) -> torch.Tensor:
    d0, _ = nn_distances(pos0, pos1)
    d1, _ = nn_distances(pos1, pos0)
    return torch.cat([torch.sqrt(d0), torch.sqrt(d1)], dim=0)


def paper_distance(gt: torch.Tensor, noisy: torch.Tensor) -> torch.Tensor:
    gt = torch.as_tensor(gt, dtype=torch.float32)
    diag = torch.linalg.norm(gt.amax(dim=0) - gt.amin(dim=0))
    d, _ = nn_distances(noisy, gt)
    return torch.sqrt(d) / diag.to(d.device)


def average_edge_length(pos: torch.Tensor, nbh: Neighborhood) -> torch.Tensor:
    """Mean neighbour distance over all valid edges of the dense (N, k)
    neighbourhood."""
    d = torch.linalg.norm(nbh.gather(pos) - pos[:, None, :], dim=-1)
    w = nbh.mask.to(pos.dtype)
    return torch.sum(d * w) / torch.clamp(torch.sum(w), min=1.0)


def pointcloud_radius(pos: torch.Tensor) -> torch.Tensor:
    """Max distance from the centroid."""
    return torch.max(torch.linalg.norm(pos - torch.mean(pos, dim=0, keepdim=True), dim=1))


def mean_angular_error(n_pred: torch.Tensor, n_gt: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean acos(n_pred . n_gt) in degrees, optionally weighted."""
    dot = torch.clamp(torch.sum(n_pred * n_gt, dim=-1), -1.0, 1.0)
    ang = torch.acos(dot) * (180.0 / math.pi)
    if weights is None:
        return torch.mean(ang)
    return torch.sum(ang * weights) / torch.clamp(torch.sum(weights), min=1e-12)


def msae(n_pred: torch.Tensor, n_gt: torch.Tensor) -> torch.Tensor:
    """RMS angular error in radians."""
    dot = torch.clamp(torch.sum(n_pred * n_gt, dim=-1), -1.0, 1.0)
    ang = torch.acos(dot)
    return torch.sqrt(torch.mean(ang * ang))
