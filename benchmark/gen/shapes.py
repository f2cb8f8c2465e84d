"""The benchmark's input shapes, frozen here so that no change to the
program can move them.

``roof_cloud`` is the repository's bench workload, a piecewise-planar "CAD
roof" (triangle waves in x and y give planar facets that meet in sharp
creases) at a point spacing of 0.01, noisy along its analytic normals.
``corner_cloud`` tiles cube corners, so that every class of the
classifier is common. ``icosphere`` is the subdivided icosahedron of the
mesh bench. Geometry that the seed does not change is built once in numpy;
every draw comes from the generator handed in, so one seed gives one
input.
"""

from __future__ import annotations

import numpy as np
import torch


def roof_grid(n: int):
    """The noiseless roof: (n, 3) positions and unit normals, float32, and
    the rows that repeat earlier ones to reach n (none when n is a square)
    left to the caller, as ``extra`` = n - side**2."""
    side = int(np.sqrt(n))
    xs = np.linspace(0.0, 10.0 * side / 1000.0, side, dtype=np.float32)
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    p, amp = 2.5, 0.5

    def tri(t):
        return 2 * np.abs(t / p - np.floor(t / p + 0.5))

    def dtri(t):
        return np.sign(((t / p + 0.5) % 1.0) - 0.5) * 2 / p

    zz = amp * (tri(xx) + tri(yy))
    pts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.float32)
    gx, gy = amp * dtri(xx).ravel(), amp * dtri(yy).ravel()
    normals = np.stack([-gx, -gy, np.ones_like(gx)], axis=-1)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return pts, normals.astype(np.float32)


def roof_cloud(n: int, noise: float, gen: torch.Generator, device):
    """(noisy, normals, clean) float32 tensors on ``device``: the roof with
    Gaussian noise of stdev ``noise`` along the normals. Where n is not a
    square, the missing rows repeat grid rows drawn from ``gen``."""
    pts, nrm = roof_grid(n)
    clean = torch.as_tensor(pts, device=device)
    normals = torch.as_tensor(nrm, device=device)
    extra = n - clean.shape[0]
    if extra > 0:
        sel = torch.randint(0, clean.shape[0], (extra,), generator=gen,
                            device=gen.device).to(device)
        clean = torch.cat([clean, clean[sel]])
        normals = torch.cat([normals, normals[sel]])
    draw = torch.randn((n, 1), generator=gen, device=gen.device, dtype=torch.float32)
    return clean + normals * (draw.to(device) * noise), normals, clean


def corner_cloud(n: int, noise: float, gen: torch.Generator, device, side: int = 8):
    """Cube corners on a 3-D grid: three square faces of ``side`` points a
    side, spacing 0.01, meeting at a vertex, each corner 3 spacings clear
    of the next; isotropic Gaussian jitter of stdev ``noise``. Returns
    (noisy, normals, clean) on ``device``."""
    s = 0.01
    a, b = [x.ravel() for x in np.meshgrid(np.arange(side) * s, np.arange(side) * s,
                                           indexing="ij")]
    z = np.zeros_like(a)
    faces = [((a, b, z), (0.0, 0.0, 1.0)), ((z, a, b), (1.0, 0.0, 0.0)),
             ((a, z, b), (0.0, 1.0, 0.0))]
    pts = np.concatenate([np.stack(p, axis=1) for p, _ in faces])
    nrm = np.concatenate([np.tile(nv, (len(a), 1)) for _, nv in faces])
    pts, idx = np.unique(pts.round(6), axis=0, return_index=True)
    nrm = nrm[idx]
    count = -(-n // len(pts))
    g = int(np.ceil(count ** (1.0 / 3.0)))
    grid = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"), axis=-1)
    offsets = grid.reshape(-1, 3)[:count] * (side + 3) * s
    clean = torch.as_tensor((pts[None] + offsets[:, None]).reshape(-1, 3)[:n].astype(np.float32),
                            device=device)
    normals = torch.as_tensor(np.tile(nrm, (count, 1))[:n].astype(np.float32), device=device)
    draw = torch.randn((n, 3), generator=gen, device=gen.device, dtype=torch.float32)
    return clean + draw.to(device) * noise, normals, clean


def icosphere(subdiv: int, radius: float):
    """(vertices (V, 3) float32, faces (F, 3) int64) numpy arrays of the
    subdivided icosahedron; every level splits a face in four at its edge
    midpoints, each midpoint made once."""
    phi = (1 + np.sqrt(5)) / 2
    v = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdiv):
        # Edges (a, b), (b, c), (c, a) of every face; one midpoint per
        # undirected edge, numbered in order of first appearance.
        e = np.stack([f, np.roll(f, -1, axis=1)], axis=-1).reshape(-1, 2)
        key = np.minimum(e[:, 0], e[:, 1]) * len(v) + np.maximum(e[:, 0], e[:, 1])
        uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        mid_id = len(v) + rank[inv].reshape(-1, 3)
        ends = e[first[order]]
        v = np.concatenate([v, (v[ends[:, 0]] + v[ends[:, 1]]) / 2])
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        ab, bc, ca = mid_id[:, 0], mid_id[:, 1], mid_id[:, 2]
        f = np.stack([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                      np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)],
                     axis=1).reshape(-1, 3)
    v = radius * v / np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), f.astype(np.int64)


def vertex_normals(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Area-weighted unit vertex normals; 0 where a vertex has no area."""
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    cr = torch.linalg.cross(p1 - p0, p2 - p0, dim=1)
    vn = torch.zeros_like(v)
    for c in range(3):
        vn.index_add_(0, f[:, c], cr)
    nrm = torch.linalg.norm(vn, dim=1, keepdim=True)
    return torch.where(nrm > 1e-30, vn / torch.clamp(nrm, min=1e-30), 0.0)


def mean_edge_length(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Mean length over the three edges of every face."""
    p0, p1, p2 = (v[f[:, c]] for c in range(3))
    e = (torch.linalg.norm(p1 - p0, dim=1) + torch.linalg.norm(p2 - p1, dim=1)
         + torch.linalg.norm(p0 - p2, dim=1))
    return torch.mean(e) / 3.0


def noisy_icosphere(subdiv: int, radius: float, level: float, gen: torch.Generator,
                    device):
    """(noisy vertices, faces, clean vertices) on ``device``: Gaussian noise
    of stdev ``level`` x the mean edge length along the vertex normals."""
    v, f = icosphere(subdiv, radius)
    v = torch.as_tensor(v, device=device)
    f = torch.as_tensor(f, device=device)
    draw = torch.randn((v.shape[0], 1), generator=gen, device=gen.device,
                       dtype=torch.float32).to(device)
    noisy = v + vertex_normals(v, f) * draw * (mean_edge_length(v, f) * level)
    return noisy, f, v
