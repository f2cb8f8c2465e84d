"""Triangle-mesh container and core mesh ops (torch), as
``ngpd_tpu/meshproc/trimesh.py``.

Face normals, areas and centroids from cross products, area-weighted
vertex normals, dense vertex->face and face->face adjacency (fixed-width
masked index arrays), the average edge length and the translate / resize /
rotate transforms. The adjacency is built on the host in numpy once a mesh
(the reference's builders, copied: the vectorized face-face adjacency
included, whose handling of repeated-vertex faces differs from a loop over
faces; the port copies it as it is); all per-element math runs on the
mesh's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import noise as noise_mod
from ..utils import prof


def face_normals_areas_centroids(v: torch.Tensor, f: torch.Tensor):
    """(F, 3) unit normals, (F,) areas, (F, 3) centroids."""
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    cr = torch.linalg.cross(p1 - p0, p2 - p0, dim=1)
    nrm = torch.linalg.norm(cr, dim=1)
    normals = cr / torch.clamp(nrm, min=1e-30)[:, None]
    areas = 0.5 * nrm
    centroids = (p0 + p1 + p2) / 3.0
    return normals, areas, centroids


def vertex_normals(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals; a vertex with no area gets 0."""
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    cr = torch.linalg.cross(p1 - p0, p2 - p0, dim=1)
    vn = torch.zeros_like(v)
    for c in range(3):
        vn.index_add_(0, f[:, c], cr)
    nrm = torch.linalg.norm(vn, dim=1, keepdim=True)
    return torch.where(nrm > 1e-30, vn / torch.clamp(nrm, min=1e-30), 0.0)


def _build_vertex_face_adjacency(f: np.ndarray, nv: int):
    """Dense (V, max_deg) incident-face indices + mask, faces in order."""
    nf = len(f)
    if nf == 0:
        return np.zeros((nv, 1), np.int32), np.zeros((nv, 1), bool)
    vi = f.ravel().astype(np.int64)  # (3F,) vertex of each corner
    fi = np.repeat(np.arange(nf, dtype=np.int64), 3)
    order = np.argsort(vi, kind="stable")  # stable: faces stay in order
    vi_s, fi_s = vi[order], fi[order]
    counts = np.bincount(vi_s, minlength=nv)
    deg = int(counts.max()) if counts.size else 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(vi_s)) - starts[vi_s]  # rank within each vertex
    idx = np.zeros((nv, deg), np.int32)
    mask = np.zeros((nv, deg), bool)
    idx[vi_s, pos] = fi_s
    mask[vi_s, pos] = True
    return idx, mask


def _build_face_face_adjacency(f: np.ndarray):
    """(F, 3) edge-adjacent faces; a boundary edge -> self with mask
    False. Each face edge gets a canonical integer key, equal keys are
    grouped by a stable sort, and every edge takes the first other face of
    its group."""
    nf = len(f)
    if nf == 0:
        return np.zeros((0, 3), np.int32), np.zeros((0, 3), bool)
    a = f.astype(np.int64)
    b = a[:, [1, 2, 0]]
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    key = lo * (int(f.max()) + 1) + hi  # unique per undirected edge
    flat_key = key.ravel()  # slot order = fi*3 + e
    order = np.argsort(flat_key, kind="stable").astype(np.int64)
    sk = flat_key[order]
    new_group = np.concatenate([[True], sk[1:] != sk[:-1]])
    group_id = np.cumsum(new_group) - 1
    group_start = np.flatnonzero(new_group)
    gsize = np.diff(np.concatenate([group_start, [len(sk)]]))
    first = order[group_start]  # first slot of each edge group
    second = order[np.minimum(group_start + 1, len(sk) - 1)]
    g_first = first[group_id]
    g_second = second[group_id]
    valid = gsize[group_id] >= 2
    partner = np.where(order == g_first, g_second, g_first)
    idx = np.empty(nf * 3, np.int32)
    mask = np.zeros(nf * 3, bool)
    own_face = (order // 3).astype(np.int32)
    idx[order] = np.where(valid, (partner // 3).astype(np.int32), own_face)
    mask[order] = valid
    return idx.reshape(nf, 3), mask.reshape(nf, 3)


def _on(device, idx: np.ndarray, mask: np.ndarray):
    return (torch.as_tensor(idx, dtype=torch.int64, device=device),
            torch.as_tensor(mask, device=device))


@dataclasses.dataclass
class TriMesh:
    """Vertices + faces on one device, with lazily built dense adjacency."""

    v: torch.Tensor  # (V, 3) float32
    f: torch.Tensor  # (F, 3) int64
    _vf: Optional[tuple] = None
    _ff: Optional[tuple] = None

    @classmethod
    def from_numpy(cls, v: np.ndarray, f: np.ndarray, device="cpu") -> "TriMesh":
        return cls(v=torch.tensor(np.asarray(v, np.float32), device=device),
                   f=torch.tensor(np.asarray(f, np.int64), device=device))

    def to(self, device) -> "TriMesh":
        """The mesh on ``device``: itself, adjacency cache and all, where
        it lies there already."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev == self.v.device:
            return self

        def move(pair):
            return None if pair is None else tuple(t.to(device) for t in pair)

        return TriMesh(v=self.v.to(device), f=self.f.to(device), _vf=move(self._vf),
                       _ff=move(self._ff))

    @property
    def num_vertices(self) -> int:
        return self.v.shape[0]

    @property
    def num_faces(self) -> int:
        return self.f.shape[0]

    def face_data(self):
        return face_normals_areas_centroids(self.v, self.f)

    def vertex_normals(self) -> torch.Tensor:
        return vertex_normals(self.v, self.f)

    def vertex_face_adjacency(self):
        if self._vf is None:
            with prof.span("ngpd.mesh.adjacency", self.v.device):
                self._vf = _on(self.v.device, *_build_vertex_face_adjacency(
                    self.f.cpu().numpy(), self.num_vertices))
        return self._vf

    def face_face_adjacency(self):
        if self._ff is None:
            with prof.span("ngpd.mesh.adjacency", self.v.device):
                self._ff = _on(self.v.device, *_build_face_face_adjacency(self.f.cpu().numpy()))
        return self._ff

    def average_edge_length(self) -> torch.Tensor:
        """Mean length over the three edges of every face."""
        p0, p1, p2 = (self.v[self.f[:, c]] for c in range(3))
        e = (torch.linalg.norm(p1 - p0, dim=1) + torch.linalg.norm(p2 - p1, dim=1)
             + torch.linalg.norm(p0 - p2, dim=1))
        return torch.mean(e) / 3.0

    def with_vertices(self, v: torch.Tensor) -> "TriMesh":
        return TriMesh(v=v, f=self.f, _vf=self._vf, _ff=self._ff)

    # --- transforms ---------------------------------------------------
    def translated(self, offset) -> "TriMesh":
        return self.with_vertices(self.v + torch.as_tensor(offset, dtype=self.v.dtype,
                                                           device=self.v.device))

    def resized(self, factor: float) -> "TriMesh":
        center = torch.mean(self.v, dim=0)
        return self.with_vertices(center + (self.v - center) * factor)

    def rotated(self, r) -> "TriMesh":
        r = torch.as_tensor(r, dtype=self.v.dtype, device=self.v.device)
        return self.with_vertices(self.v @ r.T)

    def centered_unit(self) -> "TriMesh":
        """Centre at the origin and scale to the unit box."""
        mn = torch.min(self.v, dim=0).values
        mx = torch.max(self.v, dim=0).values
        center = (mn + mx) / 2.0
        scale = torch.max(mx - mn)
        return self.with_vertices((self.v - center) / torch.clamp(scale, min=1e-30))


def add_mesh_noise(mesh: TriMesh, draws, level: float, noise_type: int = 0,
                   direction: int = 0) -> TriMesh:
    """Gaussian / impulsive vertex noise, stdev = level x average edge
    length. ``draws`` is ``core.noise.draw_noise(mesh.num_vertices,
    generator)``: the standard-normal (V, 3) draws and the permutation."""
    gauss, perm = draws
    noisy = noise_mod.apply_noise(mesh.v, mesh.vertex_normals(), gauss, perm, level,
                                  mesh.average_edge_length(), noise_type, direction)
    return mesh.with_vertices(noisy)
