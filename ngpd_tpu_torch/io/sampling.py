"""Area-weighted mesh surface sampling (numpy), a copy of
``ngpd_tpu/io/sampling.py``: the same ``np.random.default_rng(seed)``
draws, so the same points and normals bit for bit.

Replaces torch_geometric.transforms.SamplePoints as used by
Pointcloud.sampleObj (Object.py:134-156): sample ``num_points`` positions
uniformly over the surface, carrying the face normal of the source
triangle as the sample normal (include_normals=True semantics).
"""

from __future__ import annotations

import numpy as np

from ..core.cloud import PointCloud


def face_areas_normals(v: np.ndarray, f: np.ndarray):
    """Per-face (area, unit normal) from cross products (Mesh.py:110-150)."""
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    cr = np.cross(p1 - p0, p2 - p0)
    norm = np.linalg.norm(cr, axis=1)
    areas = 0.5 * norm
    normals = cr / np.maximum(norm[:, None], 1e-12)
    return areas, normals


def sample_mesh(
    v: np.ndarray, f: np.ndarray, num_points: int, seed: int = 0
) -> PointCloud:
    """Uniform area-weighted sampling with per-sample face normals."""
    rng = np.random.default_rng(seed)
    areas, normals = face_areas_normals(v, f)
    probs = areas / max(areas.sum(), 1e-30)
    face_idx = rng.choice(len(f), size=num_points, p=probs)
    # Uniform barycentric coordinates via square-root trick.
    r1 = np.sqrt(rng.random(num_points, dtype=np.float64))
    r2 = rng.random(num_points, dtype=np.float64)
    a = 1.0 - r1
    b = r1 * (1.0 - r2)
    c = r1 * r2
    tri = f[face_idx]
    pts = (
        v[tri[:, 0]] * a[:, None]
        + v[tri[:, 1]] * b[:, None]
        + v[tri[:, 2]] * c[:, None]
    )
    return PointCloud.from_numpy(
        pts.astype(np.float32), normals[face_idx].astype(np.float32)
    )
