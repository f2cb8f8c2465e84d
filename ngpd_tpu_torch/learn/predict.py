"""Learned normal prediction over whole clouds (torch), as
``ngpd_tpu/learn/predict.py``: estimate and orient normals when none are
given, extract one MD patch per point, run the Patch2Normal model in
batches, L2-normalise, and rotate each prediction back to the world frame
(``n_world = y_patch @ R_inv^T``, the inverse of ``y = gt_n @ R_inv``).

Spans (``utils/prof.py::span``, recorded only while ``torch.profiler``
records): the root ``ngpd.normals`` around a call, and its children
``.estimate`` and ``.orient`` (``core/normals.py``), ``.select``,
``.frames`` and ``.pair_knn`` (``core/patches.py``), ``.model`` (every
batch's forward) and ``.unrotate``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import PatchConfig
from ..core.normals import estimated_normals
from ..core.patches import extract_patches
from ..device import exact_float32, resolve_device
from ..utils import prof


def predict_cloud_normals(model, points: torch.Tensor,
                          normals: Optional[torch.Tensor] = None,
                          patch_cfg: PatchConfig = PatchConfig(),
                          batch_size: int = 1024, device=None) -> torch.Tensor:
    """Per-point world-frame unit normals (N, 3) for a (noisy) cloud, on
    ``device``. ``model`` is a ``Patch2NormalModel``; it is moved to the
    device and run in eval mode."""
    dev = resolve_device(device)
    exact_float32()
    with prof.span("ngpd.normals", dev):
        points = torch.as_tensor(points, dtype=torch.float32).to(dev)
        if normals is None:
            normals = estimated_normals(points)
        patches = extract_patches(points, normals, cfg=patch_cfg, device=dev)
        model = model.to(dev)
        outs = []
        with prof.span("ngpd.normals.model", dev):
            for s in range(0, points.shape[0], batch_size):
                outs.append(model.predict(patches.x[s:s + batch_size],
                                          patches.nbr_idx[s:s + batch_size],
                                          patches.nbr_mask[s:s + batch_size],
                                          patches.node_mask[s:s + batch_size]))
        with prof.span("ngpd.normals.unrotate", dev):
            pred = torch.cat(outs)  # (N, 3) in patch frames
            return unrotate(pred, patches.r_inv)


def unrotate(pred: torch.Tensor, r_inv: torch.Tensor) -> torch.Tensor:
    """einsum('ni,nji->nj'): each prediction times its frame transposed."""
    return torch.sum(pred[:, None, :] * r_inv, dim=-1)
