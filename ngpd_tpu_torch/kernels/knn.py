"""The exact brute-force kNN kernel (``csrc/knn.cu``): its wrapper.

``search`` runs the kernel on CUDA tensors, on the current stream: one
launch of ``knn_kernel`` over all the points, counted in
``LAUNCHES["knn"]``, or, where the queries are too few to fill the card,
one launch over ``slices`` slices of the points (counted the same) and one
of ``knn_merge_kernel``, which merges the slices' partial lists by key
(counted in ``LAUNCHES["knn_merge"]``). Its plain version is the tile loop
of ``ops/knn.py::knn_plain``, which ``ops/knn.py::knn`` runs on CPU
tensors; ``_check`` tells the two apart and raises on any other device.
There is no fallback from the kernel to the loop.

``split_plain`` and ``merge_plain`` are the split path's plain versions:
each slice's sorted keys (distance bits << 32) + index, empty slots -1
(~0 as the kernel writes them), and their merge.
"""

from __future__ import annotations

import torch

LAUNCHES = {"knn": 0, "knn_merge": 0}
# csrc/knn.cu: (threads a block, queries a thread) for k 1, k <= SMALL_K
# and above; a register list of 1, 8 or 16 keys up to SMALL_K, above a row
# in device memory fed through a buffer of BUF keys a query; points a
# staged tile; the split's most slices and least points a slice.
SMALL_K, BUF, TILE = 16, 32, 512
BLOCKS = {"one": (64, 4), "small": (128, 1), "large": (64, 1)}
MAX_SLICES, MIN_SLICE = 64, 8 * TILE
NONE = -1  # an empty slot's key, ~0 read as int64


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def variant(k: int) -> tuple[int, int, int]:
    """The template arguments of the ``knn_kernel`` that runs ``k``
    (``knn_dispatch``): threads a block, queries a thread, and the
    register list's length (0: a row in device memory)."""
    reg = 1 if k == 1 else 8 if k <= 8 else 16 if k <= SMALL_K else 0
    cls = "one" if k == 1 else "small" if k <= SMALL_K else "large"
    return (*BLOCKS[cls], reg)


def smem_bytes(k: int) -> int:
    """Shared memory a block of the launch at ``k`` holds: the static tile
    and, for a row list, each query's buffer (``knn_buf_bytes``, the
    launch's dynamic part)."""
    threads, queries, reg = variant(k)
    return TILE * 16 + (0 if reg else threads * queries * BUF * 8)


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


def _launch(entry: str, count: str, *args) -> None:
    """Call ``ngpd_<entry>_launch`` of the kNN library on the current stream
    and count it in ``LAUNCHES[count]``; raises LaunchError if refused."""
    from .build import load_library
    from .window import LaunchError

    fn = getattr(load_library("knn"), f"ngpd_{entry}_launch")
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise LaunchError(entry, rc)
    LAUNCHES[count] += 1


def slices(nq: int, nv: int, k: int) -> int:
    """The slices the kernel splits the points into for this search
    (``ngpd_knn_slices``: 1 where the queries fill the card)."""
    from .build import load_library

    return int(load_library("knn").ngpd_knn_slices(nq, nv, k))


def search(points: torch.Tensor, queries: torch.Tensor, k: int, num_valid: int,
           exclude_self: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest of ``points[:num_valid]`` for each query, on the card:
    ``(d (nq, k) float32, idx (nq, k) int64)``, ascending by (distance,
    index); slots with no finite neighbour hold (inf, 0). Operands as
    ``_check`` takes them, on a CUDA device."""
    nq, n = queries.shape[0], points.shape[0]
    d = torch.empty((nq, k), dtype=torch.float32, device=points.device)
    idx = torch.empty((nq, k), dtype=torch.int64, device=points.device)
    if nq and k:
        nv = max(0, min(int(num_valid), n))
        s = slices(nq, nv, k)
        ptrs = (points.data_ptr(), queries.data_ptr())
        if s == 1:
            _launch("knn", "knn", *ptrs, d.data_ptr(), idx.data_ptr(), n, nq, nv, int(k),
                    int(exclude_self))
        else:
            part = torch.empty((s, nq, k), dtype=torch.int64, device=points.device)
            _launch("knn_split", "knn", *ptrs, part.data_ptr(), n, nq, nv, int(k),
                    int(exclude_self), s)
            _launch("knn_merge", "knn_merge", part.data_ptr(), d.data_ptr(), idx.data_ptr(),
                    nq, int(k), s)
    return d, idx


def slice_bounds(nv: int, s: int) -> list[tuple[int, int]]:
    """The kernel's slices of the points [0, nv): ceil(nv / s) each."""
    step = -(-nv // s)
    return [(min(i * step, nv), min(i * step + step, nv)) for i in range(s)]


def split_plain(points: torch.Tensor, k: int, queries: torch.Tensor | None = None, *,
                exclude_self: bool = False, num_valid: int | None = None,
                bounds=None, cap: torch.Tensor | None = None) -> torch.Tensor:
    """The split path's partial lists: for each slice ``(a, b)`` of
    ``bounds`` (default one slice), each query's k smallest keys among the
    slice's points at a finite distance at or below ``cap`` (per query;
    default no cap), ascending, empty slots NONE: (slices, nq, k) int64."""
    from ..ops.knn import pairwise_sqdist

    q = points if queries is None else queries
    nq, nv = q.shape[0], points.shape[0] if num_valid is None else int(num_valid)
    bounds = [(0, nv)] if bounds is None else bounds
    rows = torch.arange(nq, device=points.device)[:, None]
    parts = []
    for a, b in bounds:
        cols = torch.arange(a, b, device=points.device)
        d = pairwise_sqdist(q, points[a:b])
        ok = torch.isfinite(d)
        if exclude_self:
            ok &= cols[None, :] != rows
        if cap is not None:
            ok &= d <= cap[:, None]
        key = ((d + 0.0).view(torch.int32).to(torch.int64) << 32) | cols[None, :]
        key = torch.where(ok, key, torch.iinfo(torch.int64).max)
        key = torch.sort(key, dim=1).values[:, :k]
        out = torch.full((nq, k), torch.iinfo(torch.int64).max, dtype=torch.int64,
                         device=points.device)
        out[:, : key.shape[1]] = key
        parts.append(torch.where(out == torch.iinfo(torch.int64).max, NONE, out))
    return torch.stack(parts)


def merge_plain(part: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``knn_merge_kernel``'s plain version: the k smallest keys of each
    query's (slices, nq, k) partial lists as ``(d, idx)``, (inf, 0) for
    empty slots."""
    s, nq, k = part.shape
    key = torch.where(part == NONE, torch.iinfo(torch.int64).max, part)
    key = torch.sort(key.permute(1, 0, 2).reshape(nq, s * k), dim=1).values[:, :k]
    empty = key == torch.iinfo(torch.int64).max
    d = (key >> 32).to(torch.int32).view(torch.float32)
    return (torch.where(empty, float("inf"), d),
            torch.where(empty, 0, key & 0xFFFFFFFF))
