"""The learned models' graph kernels: their wrappers.

``csrc/feature_knn.cu`` is the DGCNN's feature-space kNN (its plain
version is ``models/dgcnn.py::feature_knn_plain``), ``csrc/edge_block.cu``
the edge-feature block of the DGCNN and of EdgeConv (its plain version is
``models/edge.py::edge_block_plain``), ``csrc/dgcnn_epilogue.cu`` the
DGCNN's eval-mode BatchNorm, LeakyReLU and max over neighbours after a
product (its plain version is ``models/dgcnn.py::dgcnn_epilogue_plain``).
``feature_knn``, ``edge_block`` and ``dgcnn_epilogue`` launch their
kernel once on CUDA tensors, on the current stream, and add one to
``LAUNCHES``. The ``check_*`` functions tell the card from the CPU,
where the callers run the plain versions, and raise on any other device
or on operands the kernels do not take. There is no fallback from a
kernel to its plain version.
"""

from __future__ import annotations

import torch

LAUNCHES = {"feature_knn": 0, "edge_block": 0, "dgcnn_epilogue": 0}
# csrc/feature_knn.cu: one block a patch of at most 256 nodes; the patch
# streams through shared memory in slabs of 32 channels (rows pitched 36
# floats, a ring of 3); a warp owns 64 rows and 8 columns at a time; k at
# most 16, the k nearest of a row in a register list of 8 or 16 keys.
FEATURE_KNN_MAX_P, FEATURE_KNN_MAX_K = 256, 16
FEATURE_KNN_SLAB, FEATURE_KNN_PITCH, FEATURE_KNN_STAGES = 32, 36, 3
FEATURE_KNN_COLS, FEATURE_KNN_ROWS, FEATURE_KNN_WARPS = 8, 64, 8
# The launch's order argument: [x_j - x_i, x_i] and [x_i, x_j - x_i].
EDGE_ORDERS = {"dgcnn": 0, "edgeconv": 1}
# csrc/dgcnn_epilogue.cu: the neighbour counts built as template variants
# (the DGCNN's fixed graph, its feature kNN's k and conv7's 1); any other
# takes the variant that reads K at run time (0).
DGCNN_EPILOGUE_KS = (1, 3, 8)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def feature_knn_variant(k: int) -> int:
    """The register list's size a k runs with (``fknn_variant``)."""
    return 8 if k <= 8 else 16


def feature_knn_shape(p: int) -> dict:
    """A patch of ``p`` nodes as the kernel lays it out (``FknnShape``):
    row groups of 64 nodes, column groups (a warp each a row group),
    warps, threads, rounds over the chunks of 8 columns, staged rows."""
    row_groups = -(-p // FEATURE_KNN_ROWS)
    chunks = -(-p // FEATURE_KNN_COLS)
    groups = min(chunks, FEATURE_KNN_WARPS // row_groups)
    warps = row_groups * groups
    return {"row_groups": row_groups, "groups": groups, "warps": warps,
            "threads": 32 * warps, "rounds": -(-chunks // groups),
            "rows": row_groups * FEATURE_KNN_ROWS}


def feature_knn_smem_bytes(p: int) -> int:
    """Shared memory of a block (``fknn_smem_bytes``): the slab ring or a
    round's keys, whichever is larger; C does not enter."""
    s = feature_knn_shape(p)
    ring = FEATURE_KNN_STAGES * s["rows"] * FEATURE_KNN_PITCH * 4
    return max(ring, s["rows"] * s["groups"] * FEATURE_KNN_COLS * 8)


def dgcnn_epilogue_variant(k: int) -> int:
    """The template K the epilogue runs with at ``k`` neighbours."""
    return k if k in DGCNN_EPILOGUE_KS else 0


def _device(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda or cpu, not {t.device}")
    return True


def check_feature_knn(x: torch.Tensor, k: int) -> bool:
    """True when ``x`` lies on a CUDA device and the kernel takes it with
    ``k``; False on the CPU; raises on any other device or on operands the
    kernel does not take."""
    if not _device(x, "feature_knn"):
        return False
    if x.dtype != torch.float32 or x.dim() != 3:
        raise TypeError(f"feature_knn takes a (B, P, C) float32 tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("feature_knn: x must be contiguous")
    b, p, c = x.shape
    if not 1 <= p <= FEATURE_KNN_MAX_P or c < 1 or b >= 2**31:
        raise ValueError(f"feature_knn takes 1 <= P <= FEATURE_KNN_MAX_P "
                         f"({FEATURE_KNN_MAX_P}), C >= 1 and B < 2^31, got {tuple(x.shape)}")
    if not 1 <= k <= min(FEATURE_KNN_MAX_K, p):
        raise ValueError(f"feature_knn takes 1 <= k <= min(FEATURE_KNN_MAX_K "
                         f"({FEATURE_KNN_MAX_K}), P), got k {k} at P {p}")
    return True


def feature_knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, P, k) int64 indices of the kernel, on the card; operands as
    ``check_feature_knn`` takes them."""
    from .window import launch

    b, p, c = x.shape
    out = torch.empty((b, p, k), dtype=torch.int64, device=x.device)
    if b:
        launch("feature_knn", LAUNCHES, x.data_ptr(), out.data_ptr(), b, p, c, int(k))
    return out


def check_edge_block(x: torch.Tensor, idx: torch.Tensor, order: str) -> bool:
    """True when ``x`` and ``idx`` lie on a CUDA device and the kernel takes
    them; False on the CPU; raises on an unknown order, on any other device
    or on operands the kernel does not take."""
    if order not in EDGE_ORDERS:
        raise ValueError(f"edge_block: order {order!r} is none of {tuple(EDGE_ORDERS)}")
    if idx.device != x.device:
        raise ValueError(f"idx on {idx.device}, x on {x.device}")
    if not _device(x, "edge_block"):
        return False
    if x.dtype != torch.float32 or x.dim() != 3:
        raise TypeError(f"edge_block takes x as a (B, P, C) float32 tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if idx.dtype != torch.int64 or idx.dim() != 3 or idx.shape[:2] != x.shape[:2]:
        raise TypeError(f"edge_block takes idx as a (B, P, K) int64 tensor, got {idx.dtype} "
                        f"{tuple(idx.shape)} beside x {tuple(x.shape)}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("edge_block: x and idx must be contiguous")
    if max(x.shape[0], x.shape[1], x.shape[2], idx.shape[2]) >= 2**31:
        raise ValueError("edge_block: every dimension must be below 2^31")
    return True


def edge_block(x: torch.Tensor, idx: torch.Tensor, order: str) -> torch.Tensor:
    """(B, P, K, 2C) float32 edge features of the kernel in ``order``
    ("dgcnn" or "edgeconv"), on the card; operands as ``check_edge_block``
    takes them."""
    from .window import launch

    b, p, c = x.shape
    kk = idx.shape[2]
    out = torch.empty((b, p, kk, 2 * c), dtype=torch.float32, device=x.device)
    if out.numel():
        launch("edge_block", LAUNCHES, x.data_ptr(), idx.data_ptr(), out.data_ptr(), b, p, kk,
               c, EDGE_ORDERS[order])
    return out


def check_dgcnn_epilogue(h: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                         bias: torch.Tensor, k: int) -> bool:
    """True when ``h`` and the per-channel terms lie on a CUDA device and
    the kernel takes them: ``h`` (..., k, C) (at k 1 (..., C)), the terms
    (C,), all float32 and contiguous; False on the CPU; raises on any other
    device or on operands the kernel does not take."""
    if not _device(h, "dgcnn_epilogue"):
        return False
    if h.dtype != torch.float32 or h.dim() < (2 if k == 1 else 3):
        raise TypeError(f"dgcnn_epilogue takes h as a (..., K, C) float32 tensor, got "
                        f"{h.dtype} {tuple(h.shape)}")
    c = h.shape[-1]
    if k < 1 or (k > 1 and h.shape[-2] != k):
        raise ValueError(f"dgcnn_epilogue: k {k} beside h {tuple(h.shape)}")
    for name, t in (("mean", mean), ("mul", mul), ("bias", bias)):
        if t.device != h.device:
            raise ValueError(f"{name} on {t.device}, h on {h.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise TypeError(f"dgcnn_epilogue takes {name} as a ({c},) float32 tensor, got "
                            f"{t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (h, mean, mul, bias)):
        raise ValueError("dgcnn_epilogue: h, mean, mul and bias must be contiguous")
    if h.numel() // (k * c) >= 2**31 or k >= 2**31 or c >= 2**31:
        raise ValueError("dgcnn_epilogue: rows, k and C must be below 2^31")
    return True


def dgcnn_epilogue(h: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                   k: int) -> torch.Tensor:
    """The kernel's max over the k neighbours (axis -2) of
    ``lrelu(((h - mean) * mul) + bias)``, (..., C); at k 1 that activation,
    shaped as ``h``; on the card, operands as ``check_dgcnn_epilogue``
    takes them."""
    from .window import launch

    c = h.shape[-1]
    out = torch.empty(h.shape if k == 1 else h.shape[:-2] + (c,), dtype=torch.float32,
                      device=h.device)
    if out.numel():
        launch("dgcnn_epilogue", LAUNCHES, h.data_ptr(), mean.data_ptr(), mul.data_ptr(),
               bias.data_ptr(), out.data_ptr(), h.numel() // (k * c), int(k), c)
    return out
