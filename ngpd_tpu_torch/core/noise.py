"""Synthetic corruption (torch), ``generate_noise`` of ``ngpd_tpu/core/noise.py``.

The reference draws from ``jax.random``; torch's generators cannot give the
same numbers, so the port splits the function in two: ``draw_noise`` makes
the Gaussian draws and the impulsive permutation from an explicit
``torch.Generator``, and ``apply_noise`` is the pure rest, which the tests
feed with the reference's own draws. ``meshproc.trimesh.add_mesh_noise``
takes the draws.

  * stdev = mean_edge_length * noise_level;
  * direction 0 (along the normal): only the first column of the (N, 3)
    draw scales the normal; direction 1: the whole draw is the offset;
  * impulsive (type 1): a (1 - level) fraction of the offsets, chosen by
    the permutation, is zeroed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

GAUSSIAN = 0
IMPULSIVE = 1
ALONG_NORMAL = 0
RANDOM_DIRECTION = 1


def draw_noise(n: int, generator: torch.Generator):
    """Standard-normal (n, 3) draws and a permutation of n, on the
    generator's device."""
    dev = generator.device
    draws = torch.randn((n, 3), generator=generator, device=dev, dtype=torch.float32)
    perm = torch.randperm(n, generator=generator, device=dev)
    return draws, perm


def apply_noise(
    points: torch.Tensor,
    normals: torch.Tensor,
    draws: torch.Tensor,
    perm: Optional[torch.Tensor],
    noise_level: float,
    mean_edge_length,
    noise_type: int = GAUSSIAN,
    direction: int = ALONG_NORMAL,
) -> torch.Tensor:
    """Noisy positions from standard-normal ``draws`` (N, 3) and, for
    impulsive noise, a permutation ``perm`` of N."""
    n = points.shape[0]
    draws = draws.to(points.device, points.dtype) * (mean_edge_length * noise_level)
    offset = draws if direction == RANDOM_DIRECTION else normals * draws[:, 0:1]
    if noise_type == IMPULSIVE:
        # In float32, as the reference: n * (1 - 0.3) is 6.9999995 at n 10.
        keep_count = n - int(np.floor(np.float32(n) * (np.float32(1.0)
                                                       - np.float32(noise_level))))
        rank = torch.empty(n, dtype=torch.int64, device=points.device)
        rank[perm.to(points.device)] = torch.arange(n, device=points.device)
        offset = torch.where((rank < keep_count)[:, None], offset, 0.0)
    return points + offset


def save_noise(noise_dir, points, noise_level, noise_type=GAUSSIAN,
               direction=ALONG_NORMAL) -> str:
    """Persist noisy positions: one .npz per realisation in ``noise_dir``,
    named ``{type}_{direction}_{level}_{id}.npz`` with the id the count of
    entries already there. Returns the file name."""
    from pathlib import Path

    d = Path(noise_dir)
    d.mkdir(parents=True, exist_ok=True)
    noise_id = len(list(d.iterdir()))
    name = f"{noise_type}_{direction}_{noise_level}_{noise_id}.npz"
    if torch.is_tensor(points):
        points = points.detach().cpu().numpy()
    np.savez_compressed(d / name, v=np.asarray(points))
    return name


def load_noise(file_path, device=None) -> torch.Tensor:
    """Persisted noisy positions, as a tensor on ``device``."""
    from pathlib import Path

    from ..device import resolve_device

    p = Path(file_path)
    assert p.suffix == ".npz" and p.is_file(), p
    with np.load(p) as data:
        v = data["v"]
    return torch.as_tensor(v).to(resolve_device(device))
