"""Mesh error metrics and the error-map colours (torch), as
``ngpd_tpu/meshproc/metrics.py``: Ea (mean angular error over
corresponding faces, degrees), MSAE (RMS angular error, degrees), Dv
(area-weighted RMS point-to-plane distance of the denoised vertices to the
original face planes) and per-vertex colours bucketed at 0-20-40 degrees.
"""

from __future__ import annotations

import numpy as np
import torch

from .trimesh import TriMesh

VERTEX_DISTANCE_CHUNK = 1024  # queries a (chunk, Fo) plane-distance block


def _face_angles_deg(a: TriMesh, b: TriMesh) -> torch.Tensor:
    na, _, _ = a.face_data()
    nb, _, _ = b.face_data()
    dot = torch.clamp(torch.sum(na * nb, dim=1), -1.0, 1.0)
    return torch.rad2deg(torch.acos(dot))


def mean_angular_error(denoised: TriMesh, original: TriMesh) -> torch.Tensor:
    """Ea, degrees."""
    return torch.mean(_face_angles_deg(denoised, original))


def msae(denoised: TriMesh, original: TriMesh) -> torch.Tensor:
    """RMS angular error, degrees."""
    ang = _face_angles_deg(denoised, original)
    return torch.sqrt(torch.mean(ang * ang))


def vertex_distance(denoised: TriMesh, original: TriMesh) -> torch.Tensor:
    """Dv: per denoised vertex the least |(q - face_vertex0) . face_normal|
    over the original faces, then sqrt(sum_v sum_{f incident v} area_f
    min_dis^2 / (3 total_area))."""
    n_o, _, _ = original.face_data()
    v0_o = original.v[original.f[:, 0]]  # (Fo, 3)
    q = denoised.v
    mins = torch.cat([
        torch.amin(torch.abs(torch.sum((qc[:, None, :] - v0_o[None]) * n_o[None], dim=-1)),
                   dim=1)
        for qc in torch.split(q, VERTEX_DISTANCE_CHUNK)
    ])
    _, areas_d, _ = denoised.face_data()
    vf_idx, vf_mask = denoised.vertex_face_adjacency()
    a_incident = torch.sum(torch.where(vf_mask, areas_d[vf_idx], 0.0), dim=1)
    mean_ev = torch.sum(a_incident * mins * mins)
    total_area = torch.sum(areas_d)
    return torch.sqrt(mean_ev / torch.clamp(3.0 * total_area, min=1e-30))


def error_map_colors(denoised: TriMesh, original: TriMesh) -> np.ndarray:
    """Per-vertex RGB from the incident faces' mean angular error:
    blue->green over [0, 20), green->red over [20, 40), red above."""
    ang = _face_angles_deg(denoised, original).cpu().numpy()
    vf_idx, vf_mask = (t.cpu().numpy() for t in denoised.vertex_face_adjacency())
    vert_ang = np.where(vf_mask, ang[vf_idx], 0.0).sum(1) / np.maximum(vf_mask.sum(1), 1)
    colors = np.zeros((len(vert_ang), 3), np.float32)
    low = vert_ang < 20.0
    mid = (vert_ang >= 20.0) & (vert_ang < 40.0)
    hi = vert_ang >= 40.0
    t = vert_ang / 20.0
    colors[low] = np.stack([np.zeros_like(t[low]), t[low], 1.0 - t[low]], axis=1)
    t2 = (vert_ang - 20.0) / 20.0
    colors[mid] = np.stack([t2[mid], 1.0 - t2[mid], np.zeros_like(t2[mid])], axis=1)
    colors[hi] = [1.0, 0.0, 0.0]
    return colors
