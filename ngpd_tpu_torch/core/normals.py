"""Normal estimation and consistent orientation (torch), as
``ngpd_tpu/core/normals.py``.

PVT normal estimation is the eigenvector of the smallest eigenvalue of
the local neighbour covariance, as masked (N, k) reductions and the
closed-form eigh. Orientation is iterative wavefront sign propagation:
starting from the max-z seed, every unvisited point adjacent to the
visited set adopts the sign that aligns it with the confidence-weighted
vote of its visited neighbours. Each sweep is one masked (N, k) reduction;
the loop runs on the host and reads "grew" once a sweep, and counts
each sweep in ``SWEEPS["orient"]``. ``estimated_normals`` records the
spans ``ngpd.normals.estimate`` (the search and PVT) and
``ngpd.normals.orient`` (``utils/prof.py::span``). The exact host-side
MST + DFS is kept (numpy) for small-cloud golden tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.eigh3 import eigh3x3
from ..ops.knn import knn
from ..ops.neighbors import Neighborhood, outer3
from ..utils import prof

# cos(7/12 * pi): flip when alignment falls below this.
FLIP_THRESHOLD = float(np.cos(7.0 / 12.0 * np.pi))

SWEEPS = {"orient": 0}  # orient_normals' sweeps, counted as they run


def pvt_decomposition(points: torch.Tensor, nbh: Neighborhood):
    """Eigendecomposition of the covariance of each point's neighbours
    about their own mean. Returns (eigval (N, 3), eigvec (N, 3, 3))."""
    vj = nbh.gather(points)
    center = nbh.mean(vj)
    dv = vj - center[:, None, :]
    return eigh3x3(nbh.sum(outer3(dv, dv)))


def pvt_normals(points: torch.Tensor, nbh: Neighborhood) -> torch.Tensor:
    """Unit normals, the smallest-eigenvalue eigenvector."""
    _, eigvec = pvt_decomposition(points, nbh)
    return eigvec[..., :, 0]


def tangent_basis(points: torch.Tensor, nbh: Neighborhood):
    """Per-point right-handed orthonormal frame (normal, x_basis,
    y_basis): the smallest- and largest-eigenvalue eigenvectors of the
    neighbour covariance and their cross product, each (N, 3)."""
    _, eigvec = pvt_decomposition(points, nbh)
    nrm = eigvec[..., :, 0]
    t1 = eigvec[..., :, 2]
    t2 = torch.linalg.cross(nrm, t1)
    t2 = t2 / torch.clamp(torch.linalg.norm(t2, dim=-1, keepdim=True), min=1e-12)
    return nrm, t1, t2


def orient_normals(points: torch.Tensor, normals: torch.Tensor, nbh: Neighborhood,
                   max_sweeps: int = 0) -> torch.Tensor:
    """Consistently orient normals by wavefront sign propagation.

    Seed: the max-z point, forced to n_z >= 0. Each sweep, every unvisited
    point with at least one visited neighbour takes sign =
    sign(sum_j visited_j * w_ij * (ni.nj) * sign_j) with confidence weight
    w_ij = |ni.nj|. Runs until the visited set stops growing (or
    ``max_sweeps``). Points in disconnected components keep their sign.
    """
    n = points.shape[0]
    if max_sweeps <= 0:
        max_sweeps = 4 * int(np.ceil(np.sqrt(n))) + 16

    z = points[:, 2]
    seed = torch.argmax(torch.where(torch.isfinite(z), z, float("-inf")))
    sign = torch.ones(n, dtype=points.dtype, device=points.device)
    sign[seed] = torch.where(normals[seed, 2] < 0, -1.0, 1.0)
    visited = torch.zeros(n, dtype=torch.bool, device=points.device)
    visited[seed] = True

    dots = torch.sum(nbh.gather(normals) * normals[:, None, :], dim=-1)  # (N, k)
    weighted = torch.abs(dots) * dots
    for _ in range(max_sweeps):
        SWEEPS["orient"] += 1
        vis_j = visited[nbh.idx] & nbh.mask
        vote = torch.sum(torch.where(vis_j, weighted * sign[nbh.idx], 0.0), dim=1)
        frontier = (~visited) & (torch.sum(vis_j, dim=1) > 0)
        sign = torch.where(frontier & (vote < 0), -sign, sign)
        visited = visited | frontier
        if not bool(torch.any(frontier)):
            break
    return normals * sign[:, None]


def estimated_normals(points: torch.Tensor, k: int = 12) -> torch.Tensor:
    """PVT normals over the k nearest other points, oriented: what the
    CLI and ``predict_cloud_normals`` use when a cloud has no normals."""
    with prof.span("ngpd.normals.estimate", points.device):
        nbh, _ = knn(points, k, exclude_self=True)
        normals = pvt_normals(points, nbh)
    with prof.span("ngpd.normals.orient", points.device):
        return orient_normals(points, normals, nbh)


def orient_normals_mst(
    points: np.ndarray, normals: np.ndarray, idx: np.ndarray
) -> np.ndarray:
    """Host-side exact MST + DFS orientation for golden tests.

    Faithful semantics of GraphBuilder.flipNormals (GraphBuilder.py:129-209):
    Kruskal over edge cost 1 - |ni.nj|, then DFS from the max-z vertex
    flipping a neighbor when (n_src . n_dest) < cos(7/12 pi). Iterative
    stack instead of recursion; numpy only (small clouds).
    """
    points = np.asarray(points)
    normals = np.asarray(normals).copy()
    idx = np.asarray(idx)
    n, k = idx.shape
    # Undirected candidate edges (i, j) from the kNN graph.
    src = np.repeat(np.arange(n), k)
    dst = idx.reshape(-1)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    cost = 1.0 - np.abs(np.sum(normals[src] * normals[dst], axis=1))
    order = np.argsort(cost, kind="stable")

    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    adj: list[list[int]] = [[] for _ in range(n)]
    for e in order:
        a, b = int(src[e]), int(dst[e])
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
            adj[a].append(b)
            adj[b].append(a)

    start = int(np.argmax(points[:, 2]))
    if normals[start, 2] < 0:
        normals[start] *= -1
    visited = np.zeros(n, dtype=bool)
    stack = [start]
    visited[start] = True
    while stack:
        srcn = stack.pop()
        for destn in adj[srcn]:
            if not visited[destn]:
                visited[destn] = True
                if float(np.dot(normals[srcn], normals[destn])) < FLIP_THRESHOLD:
                    normals[destn] *= -1
                stack.append(destn)
    return normals
