"""Interop with the reference's ``.mat`` patch archives.

Users of the reference have patch datasets on disk in two flavors:

* **DenoisingGCN** files ``{MAT, FEA, GT, NOR}`` where MAT is a square
  (F, F) binary face-adjacency matrix, FEA is stored transposed
  (17, F), GT/NOR are the ground-truth and noisy center normals
  (DenoisingGCN/datautils.py:30-81).
* **PatchGeneration** files ``{MAT, FEA, GT, ROT}`` where MAT is the
  (F, 3) triangle-triangle adjacency with -1 fill and ROT is the
  patch-alignment rotation (PatchGeneration/Modules/Mesh.py:510-529,
  toGraph at 497-506).

``load_mat_patch`` accepts both and reproduces the reference's
crop/pad-to-N and 3-neighbor-triplet rules (datautils.py:40-70):
empty row -> [N-1]*3, one neighbor -> replicated thrice, two -> last
duplicated; rows with more than three ones are truncated to the first
three (the reference would crash on such a row — ragged np.array —
so truncation only widens what can be read). The result is the
(20, N) network input consumed by ``models.dgcnn.DGCNN``.

The port's own copy of ``ngpd_tpu/io/matpatch.py`` (numpy and scipy only), so that
the port imports nothing of the JAX package; ``tests/test_torch_train_data.py``
holds the two equal.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import scipy.io as sio


def _triplets_from_rows(neighbor_rows, num_nodes: int) -> np.ndarray:
    out = np.empty((num_nodes, 3), np.float32)
    for i, row in enumerate(neighbor_rows):
        row = [int(r) for r in row][:3]
        if not row:
            row = [num_nodes - 1] * 3
        while len(row) < 3:
            row.append(row[-1])
        out[i] = row
    return out


def load_mat_patch(path: Union[str, Path], num_nodes: int = 64) -> dict:
    """Load a reference ``.mat`` patch into network-ready arrays.

    Returns a dict with ``x`` (20, num_nodes) float32 — rows 0:17 the
    node features, rows 17:20 the neighbor index triplets — plus
    ``gt_norm`` (3,), and ``center_norm`` / ``rotation`` when the file
    carries NOR / ROT.
    """
    data = sio.loadmat(str(path))
    mat = np.asarray(data["MAT"])
    fea = np.asarray(data["FEA"]).T.astype(np.float32)  # stored (17, F)
    f = mat.shape[0]

    if mat.ndim == 2 and mat.shape[0] == mat.shape[1]:
        # DenoisingGCN flavor: square binary adjacency.
        if f >= num_nodes:
            mat = mat[:num_nodes, :num_nodes]
            fea = fea[:num_nodes]
        else:
            mat = np.pad(mat, ((0, num_nodes - f), (0, num_nodes - f)))
            fea = np.pad(fea, ((0, num_nodes - f), (0, 0)))
        rows = [np.flatnonzero(mat[i] == 1) for i in range(num_nodes)]
    else:
        # PatchGeneration flavor: (F, 3) tri-tri adjacency, -1 fill.
        if f >= num_nodes:
            adj = mat[:num_nodes]
            fea = fea[:num_nodes]
            rows = [[j for j in r if 0 <= j < num_nodes] for r in adj]
        else:
            fea = np.pad(fea, ((0, num_nodes - f), (0, 0)))
            rows = [[j for j in r if j >= 0] for r in mat]
            rows += [[] for _ in range(num_nodes - f)]

    triplets = _triplets_from_rows(rows, num_nodes)
    x = np.concatenate([fea, triplets], axis=1).T  # (20, num_nodes)

    out = {"x": x.astype(np.float32)}
    if "GT" in data:
        out["gt_norm"] = np.asarray(data["GT"], np.float32).reshape(-1)[:3]
    if "NOR" in data:
        out["center_norm"] = np.asarray(data["NOR"], np.float32).reshape(-1)[:3]
    if "ROT" in data:
        out["rotation"] = np.asarray(data["ROT"], np.float32).reshape(3, 3)
    return out


def save_mat_patch(
    path: Union[str, Path],
    adjacency: np.ndarray,
    features: np.ndarray,
    gt_norm: np.ndarray,
    center_norm: Optional[np.ndarray] = None,
    rotation: Optional[np.ndarray] = None,
) -> None:
    """Write a patch the reference's tools can read.

    ``adjacency`` may be square (F, F) binary or (F, 3) tri-tri with -1
    fill; ``features`` is (F, 17) and is stored transposed like the
    reference writes it (Mesh.py:520-529).
    """
    payload = {
        "MAT": np.asarray(adjacency),
        "FEA": np.asarray(features, np.float32).T,
        "GT": np.asarray(gt_norm, np.float32).reshape(3, 1),
    }
    if center_norm is not None:
        payload["NOR"] = np.asarray(center_norm, np.float32).reshape(3, 1)
    if rotation is not None:
        payload["ROT"] = np.asarray(rotation, np.float32).reshape(3, 3)
    sio.savemat(str(path), payload)
