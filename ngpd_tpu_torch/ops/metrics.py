"""Chamfer-family geometry metrics (torch), as ``ngpd_tpu/ops/metrics.py``.

  * chamfer_distance: bi-directional squared NN distances, concatenated
    (callers take ``.mean()``);
  * single_chamfer_distance: the one-sided term;
  * hausdorff_distance: NN (non-squared) distances both ways;
  * paper_distance: for each noisy point, its NN distance to the GT over
    the GT bounding-box diagonal.
"""

from __future__ import annotations

import torch

from .knn import nn_distances


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
