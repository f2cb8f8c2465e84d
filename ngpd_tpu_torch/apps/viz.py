"""Headless visualisation, as ``ngpd_tpu/apps/viz.py``.

Everything renders to PNG with matplotlib's Agg backend, so it works on a
host without a display, with the reference's figure size, dpi and colours:

  * ``plot_cloud`` — 3D scatter with optional per-point colours and normal
    quivers;
  * ``plot_classes`` — the face / edge / corner colouring;
  * ``plot_tensor_voting`` — eigenvalue-scaled eigenvector axes at a
    subsample of the points.

Inputs are numpy arrays or torch tensors on any device. matplotlib is
imported here, not by the package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

CLASS_COLORS = np.array(
    [[0.2, 0.6, 1.0], [1.0, 0.7, 0.1], [1.0, 0.1, 0.1]]
)  # face / edge / corner


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _new_ax():
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    ax.set_box_aspect((1, 1, 1))
    return fig, ax


def plot_cloud(
    points,
    colors: Optional[np.ndarray] = None,
    normals=None,
    out: str | Path = "cloud.png",
    point_size: float = 2.0,
    quiver_scale: float = 0.05,
):
    points = _np(points)
    if isinstance(colors, torch.Tensor):
        colors = _np(colors)
    fig, ax = _new_ax()
    ax.scatter(*points.T, s=point_size, c=colors)
    if normals is not None:
        normals = _np(normals)
        scale = quiver_scale * float(np.linalg.norm(points.max(0) - points.min(0)))
        ax.quiver(*points.T, *(normals.T * scale), length=1.0, linewidth=0.3,
                  color="gray")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return Path(out)


def plot_classes(points, classes, out: str | Path = "classes.png"):
    cls = _np(classes).clip(0, 2)
    return plot_cloud(points, colors=CLASS_COLORS[cls], out=out)


def plot_tensor_voting(
    points,
    eigval,
    eigvec,
    out: str | Path = "voting.png",
    sample: int = 200,
):
    """Eigenvalue-scaled frames at a point subsample."""
    points, eigval, eigvec = _np(points), _np(eigval), _np(eigvec)
    stride = max(1, len(points) // sample)
    fig, ax = _new_ax()
    ax.scatter(*points.T, s=1.0, c="lightgray")
    scale = 0.03 * float(np.linalg.norm(points.max(0) - points.min(0)))
    colors = ["r", "g", "b"]
    for axis in range(3):
        vec = eigvec[::stride, :, axis] * (eigval[::stride, axis : axis + 1] * scale)
        ax.quiver(*points[::stride].T, *vec.T, length=1.0, linewidth=0.5,
                  color=colors[axis])
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return Path(out)
