"""The exact brute-force kNN kernel (``csrc/knn.cu``): its wrapper.

``search`` launches the kernel once on CUDA tensors, on the current
stream, and adds one to ``LAUNCHES["knn"]``. Its plain version is the
tile loop of ``ops/knn.py::knn_plain``, which ``ops/knn.py::knn`` runs on
CPU tensors; ``_check`` tells the two apart and raises on any other
device. There is no fallback from the kernel to the loop.
"""

from __future__ import annotations

import torch

LAUNCHES = {"knn": 0}
REGISTER_KS = (1, 8, 16, 32, 64)  # the register variants' list sizes (knn_variant)


def reset_launch_counts() -> None:
    LAUNCHES["knn"] = 0


def variant(k: int) -> int:
    """The list size the kernel runs ``k`` with: the smallest register
    variant that holds it, or 0 for the row kernel (its list in the output
    row), as ``knn_variant`` in csrc/knn.cu."""
    return next((v for v in REGISTER_KS if k <= v), 0)


def _check(points: torch.Tensor, queries: torch.Tensor) -> bool:
    """True when the operands lie on a CUDA device and the kernel takes
    them; False on the CPU (the plain version takes what it always took);
    raises on any other device or on operands the kernel does not take."""
    if queries.device != points.device:
        raise ValueError(f"queries on {queries.device}, points on {points.device}")
    if points.device.type == "cpu":
        return False
    if points.device.type != "cuda":
        raise RuntimeError(f"knn runs on cuda or cpu, not {points.device}")
    for name, t in (("points", points), ("queries", queries)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3:
            raise TypeError(f"{name} must be an (n, 3) float32 tensor, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape[0] >= 2**31:
            raise ValueError(f"{name}: the kernel takes fewer than 2^31 rows")
    return True


def search(points: torch.Tensor, queries: torch.Tensor, k: int, num_valid: int,
           exclude_self: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest of ``points[:num_valid]`` for each query, on the card:
    ``(d (nq, k) float32, idx (nq, k) int64)``, ascending by (distance,
    index); slots with no finite neighbour hold (inf, 0). Operands as
    ``_check`` takes them, on a CUDA device."""
    from .window import launch

    nq = queries.shape[0]
    d = torch.empty((nq, k), dtype=torch.float32, device=points.device)
    idx = torch.empty((nq, k), dtype=torch.int64, device=points.device)
    if nq and k:
        nv = max(0, min(int(num_valid), points.shape[0]))
        launch("knn", LAUNCHES, points.data_ptr(), queries.data_ptr(), d.data_ptr(),
               idx.data_ptr(), points.shape[0], nq, nv, int(k), int(exclude_self))
    return d, idx
