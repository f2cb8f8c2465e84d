"""The inputs ``chip_smoke.py`` holds the kNN kernels to on the card, at
the main path's sizes; ``kernel_lab --smoke-cases`` times the kernels on the
same inputs. Made on the CPU from fixed seeds (``bench``'s clouds and mesh).
"""

from __future__ import annotations

import torch

from . import bench
from .learn.weights import load_dgcnn_state_dict
from .meshproc import gcn_denoiser as gcn
from .meshproc.patches import extract_mesh_patches
from .models import dgcnn as dgcnn_mod
from .models.dgcnn import dgcnn_from_state_dict

MAIN_N = 1_000_000  # the main cloud
DENSE_N = 32_768  # under the CLI's 100k route to the hybrid engine
MESH_SUBDIV = 6  # the mesh cascade: the reference bench's workload (bench.py:143-173)

# The kNN kernel (csrc/knn.cu) against its plain version on the card, held
# with torch.equal: the point track's cloud (k 16, plain, exclude_self,
# num_valid n - 50; k 64, md_selection's patch membership), the mesh cell's
# centroids (k 64), k 1 through nn_distances at the Chamfer gate's shape
# (bench.cd_ratio: KNN_NN_QUERIES clean points against as many noisy ones
# of the main cloud) and with KNN_NN_QUERIES clean points against the whole
# main cloud (few queries, many points), KNN_SPLIT_QUERIES clean points at
# k 16 against the whole main cloud (the split at its most slices), the
# dense cell's cloud at the dense route's k (6, 8, 16) and at k 24, an
# integer lattice (exact ties), separate queries, k past the valid count,
# and k 65 and 128 (lists in device memory); then the dense cloud at k 8
# where the skip of far tiles engages little or not at all: its rows
# shuffled, shifted DENSE_SHIFT from the origin (the margin outgrows every
# gap), and with non-finite rows (NaN, and |p|^2 past the float range).
KNN_N, KNN_K, KNN_NN_QUERIES, KNN_LATTICE_SIDE = 100_000, 16, 20_000, 40
KNN_SPLIT_QUERIES = 2_000
DENSE_SHIFT = 1000.0
# The feature kNN: the mesh cell's k on small-integer features whose last
# FKNN_EQUAL_ROWS rows a patch are equal, at each width, then on the mesh
# cell's activations.
FKNN_K, FKNN_WIDTHS, FKNN_EQUAL_ROWS = 8, (128, 256), 24


def knn_kernel_cases(n: int = KNN_N, mesh_subdiv: int = MESH_SUBDIV,
                     nn_points: int = MAIN_N, nn_queries: int = KNN_NN_QUERIES,
                     lattice_side: int = KNN_LATTICE_SIDE,
                     dense_n: int = DENSE_N, split_queries: int = KNN_SPLIT_QUERIES) -> list[dict]:
    """chip_smoke's knn_kernel cases, on the CPU: each names its points, its
    queries (None for the points themselves), k and the masks; ``nn`` marks
    the cases that go through ``nn_distances``."""
    noisy = torch.as_tensor(bench.make_cloud(n)[0])
    cents = bench.mesh_workload(mesh_subdiv)[1].face_data()[2]
    main_noisy, _, main_clean = bench.make_cloud(nn_points)
    gate = bench.gate_sample(nn_points, nn_queries)
    stride = max(1, nn_points // nn_queries)
    dense = torch.as_tensor(bench.make_cloud(dense_n)[0])
    shuffle = torch.Generator().manual_seed(0)
    nonfinite = dense.clone()
    nonfinite[::97] = float("nan")
    nonfinite[5::193, 1] = float("nan")
    nonfinite[11::389] = 1e30  # |p|^2 overflows: every distance is inf
    g = torch.arange(lattice_side, dtype=torch.float32)
    lattice = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), dim=-1).reshape(-1, 3)

    def case(name, points, k, queries=None, exclude_self=False, num_valid=None, nn=False):
        return {"case": name, "points": points, "queries": queries, "k": k,
                "exclude_self": exclude_self, "num_valid": num_valid, "nn": nn}

    return [
        case("cloud", noisy, KNN_K),
        case("cloud_exclude_self", noisy, KNN_K, exclude_self=True),
        case("cloud_num_valid", noisy, KNN_K, num_valid=n - 50),
        case("roof_k64", noisy, 64),  # core/patches.py::md_selection's patch membership
        case("mesh_centroids", cents, 64),
        case("chamfer_gate", torch.as_tensor(main_noisy[gate]), 1,
             torch.as_tensor(main_clean[gate]), nn=True),
        case("nn_whole_cloud", torch.as_tensor(main_noisy), 1,
             torch.as_tensor(main_clean[::stride][:nn_queries]), nn=True),
        case("split", torch.as_tensor(main_noisy), KNN_K,
             torch.as_tensor(main_clean[:: max(1, nn_points // split_queries)][:split_queries])),
        # core/pipeline.py's threshold 6-NN, step_k and feature_k, then
        # core/process.py's 6-NN and a k past the register lists.
        case("dense_k6", dense, 6, num_valid=dense_n),
        case("dense_k8", dense, 8, num_valid=dense_n),
        case("dense_k16", dense, 16),
        case("dense_k6_exclude_self", dense, 6, exclude_self=True),
        case("dense_k24_exclude_self", dense, 24, exclude_self=True),
        case("lattice_ties", lattice, KNN_K, exclude_self=True),
        case("separate_queries", noisy, 12, noisy[::5] + 0.003, num_valid=n - 50),
        case("k_past_valid", noisy, KNN_K, noisy[:4096], num_valid=10),
        case("k65", noisy, 65, exclude_self=True),
        case("k128", noisy, 128),
        case("dense_shuffled", dense[torch.randperm(dense_n, generator=shuffle)], 8),
        case("dense_far", dense + DENSE_SHIFT, 8),
        case("dense_nonfinite", nonfinite, 8, exclude_self=True),
    ]


def run_knn_case(case: dict, knn_fn, nn_fn, device: str):
    """(idx, mask, d) of one case through ``knn_fn`` (or ``nn_fn``)."""
    pts = case["points"].to(device)
    q = None if case["queries"] is None else case["queries"].to(device)
    if case["nn"]:
        d, idx = nn_fn(q, pts, num_valid_b=case["num_valid"])
        return idx[:, None], torch.isfinite(d)[:, None], d[:, None]
    nbh, d = knn_fn(pts, case["k"], q, exclude_self=case["exclude_self"],
                    num_valid=case["num_valid"])
    return nbh.idx, nbh.mask, d


def int_features(b: int, p: int, c: int, generator: torch.Generator) -> torch.Tensor:
    """Features 0, 1 or 2, the last FKNN_EQUAL_ROWS rows of each patch 0."""
    x = torch.randint(0, 3, (b, p, c), generator=generator).float()
    x[:, p - FKNN_EQUAL_ROWS:] = 0.0
    return x


def mesh_activations(device: str, subdiv: int, batch: int) -> list[torch.Tensor]:
    """The inputs of the DGCNN's feature kNN (conv4 to conv6) in one forward
    of the committed pass-1 model over the mesh cell's first ``batch``
    patches."""
    _, noisy = bench.mesh_workload(subdiv)
    inputs = extract_mesh_patches(noisy.to(device), device=device).inputs[:batch]
    model = dgcnn_from_state_dict(load_dgcnn_state_dict(bench.ASSETS / "dgcnn_mesh.npz"))
    seen, knn_of = [], dgcnn_mod.feature_knn

    def capture(x, k):
        seen.append(x.clone())
        return knn_of(x, k)

    dgcnn_mod.feature_knn = capture
    try:
        gcn.run_dgcnn(model.to(device), inputs, batch)
    finally:
        dgcnn_mod.feature_knn = knn_of
    return seen
