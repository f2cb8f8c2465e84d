"""XYZ point-file IO (x y z [nx ny nz] per line), as ``ngpd_tpu/io/xyz.py``."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from ..core.cloud import PointCloud


def load_xyz(file_path: str | Path) -> PointCloud:
    path = Path(file_path)
    assert path.is_file(), path
    assert path.suffix in (".xyz", ".clean_xyz"), path.suffix
    data = np.loadtxt(path, dtype=np.float32, ndmin=2)
    if data.shape[1] >= 6:
        return PointCloud.from_numpy(data[:, :3], data[:, 3:6])
    return PointCloud.from_numpy(data[:, :3])


def save_xyz(
    file_path: str | Path, points: np.ndarray, normals: Optional[np.ndarray] = None
) -> None:
    pts = np.asarray(points)
    out = pts if normals is None else np.concatenate([pts, np.asarray(normals)], axis=1)
    np.savetxt(file_path, out, fmt="%.8g")
