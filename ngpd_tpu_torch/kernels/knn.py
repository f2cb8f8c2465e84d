"""The exact brute-force kNN kernel (``csrc/knn.cu``): its wrapper.

``search`` runs the kernel on CUDA tensors, on the current stream: one
launch of ``knn_kernel_boxes``, which boxes each tile of the points
(counted in ``LAUNCHES["knn_boxes"]``), then one launch of ``knn_kernel``
over all the points, counted in ``LAUNCHES["knn"]``; or, where the queries
are too few to fill the card, one launch of ``knn_kernel`` that takes each
query's cap from its home tile and boxes the tiles
(``LAUNCHES["knn_caps"]``), one over ``slices`` slices of the points under
those caps (counted in ``LAUNCHES["knn"]``) and one of
``knn_merge_kernel``, which merges the slices' partial lists by key
(counted in ``LAUNCHES["knn_merge"]``). Each warp of the search skips a
tile, and in a tile it takes a chunk, whose box none of its queries can
reach; what the warps took and scanned and what a full scan takes are
summed on the card, and ``scan_counts`` reads them. Its plain version is
the tile loop of ``ops/knn.py::knn_plain``, which ``ops/knn.py::knn`` runs
on CPU tensors; ``_check`` tells the two apart and raises on any other
device. There is no fallback from the kernel to the loop.

``split_plain`` and ``merge_plain`` are the split path's plain versions:
each slice's sorted keys (distance bits << 32) + index, empty slots -1
(~0 as the kernel writes them), and their merge. ``tile_boxes_plain``,
``needs_plain`` and ``scanned_plain`` are the skip's: the boxes, the
margin and each query's test, and what a warp scans.
"""

from __future__ import annotations

import torch

LAUNCHES = {"knn": 0, "knn_merge": 0, "knn_boxes": 0, "knn_caps": 0}
# csrc/knn.cu: (threads a block, queries a thread) for k 1, k <= SMALL_K
# and above; a register list of 1, 8 or 16 keys up to SMALL_K, above a row
# in device memory fed through a buffer of BUF keys a query; points a
# staged tile; the split's most slices and least points a slice.
SMALL_K, BUF, TILE = 16, 32, 512
BLOCKS = {"one": (64, 4), "small": (128, 1), "large": (64, 1)}
MAX_SLICES, MIN_SLICE = 64, 8 * TILE
CHUNK = 64  # points a chunk of a tile, boxed on its own
MARKED = 1024  # tiles of a slice whose chunks a warp marks done
NONE = -1  # an empty slot's key, ~0 read as int64
# The skip's margin (knn_needs): ULPS (|q|^2 + |p|^2) + TINY bounds
# |computed - true| of a distance; past TOP nothing is skipped.
ULPS, TINY, TOP = 16 * 2.0**-24, 1e-36, 2.0**126
SCAN_COUNTS = ("tiles_taken", "tiles_offered", "chunks_scanned", "chunks_offered")
_COUNTS: dict = {}  # device -> (4,) int64, SCAN_COUNTS in order


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for c in _COUNTS.values():
        c.zero_()


def scan_counts() -> dict:
    """What the searches since the last ``reset_launch_counts`` scanned,
    summed over warps: the tiles taken and those a full scan takes (the
    home tile and every tile of the slice), and the chunks scanned and
    those of the offered tiles; one host sync."""
    got = [c.tolist() for c in _COUNTS.values()]
    return {name: sum(g[i] for g in got) for i, name in enumerate(SCAN_COUNTS)}


def _counts(device: torch.device) -> torch.Tensor:
    if device not in _COUNTS:
        _COUNTS[device] = torch.zeros(len(SCAN_COUNTS), dtype=torch.int64, device=device)
    return _COUNTS[device]


def variant(k: int) -> tuple[int, int, int]:
    """The template arguments of the ``knn_kernel`` that runs ``k``
    (``knn_dispatch``): threads a block, queries a thread, and the
    register list's length (0: a row in device memory)."""
    reg = 1 if k == 1 else 8 if k <= 8 else 16 if k <= SMALL_K else 0
    cls = "one" if k == 1 else "small" if k <= SMALL_K else "large"
    return (*BLOCKS[cls], reg)


def smem_bytes(k: int) -> int:
    """Shared memory a block of the launch at ``k`` holds: each warp's
    staged chunk and its bytes of done chunks (static) and, for a row list,
    each query's buffer (``knn_buf_bytes``, the launch's dynamic part)."""
    threads, queries, reg = variant(k)
    return threads // 32 * (CHUNK * 16 + MARKED) + (0 if reg else threads * queries * BUF * 8)


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


def _boxes(points: torch.Tensor, nv: int) -> torch.Tensor:
    """Room for the boxes of the tiles of ``points[:nv]`` and of their
    chunks, (tiles + tiles TILE / CHUNK, 8) float32."""
    tiles = max(1, -(-nv // TILE))
    return torch.empty((tiles * (1 + TILE // CHUNK), 8), dtype=torch.float32,
                       device=points.device)


def split(points: torch.Tensor, queries: torch.Tensor, k: int, nv: int, exclude_self: bool,
          s: int) -> torch.Tensor:
    """The split search alone at ``s`` slices: one launch takes each
    query's cap from its home tile and boxes the tiles (counted in
    ``LAUNCHES["knn_caps"]``), one each slice's sorted keys under the caps,
    (s, nq, k) int64, empty slots NONE."""
    nq, n = queries.shape[0], points.shape[0]
    boxes = _boxes(points, nv)
    counts = _counts(points.device).data_ptr()
    part = torch.empty((s, nq, k), dtype=torch.int64, device=points.device)
    caps = torch.empty(nq, dtype=torch.float32, device=points.device)
    ptrs = (points.data_ptr(), queries.data_ptr(), part.data_ptr(), boxes.data_ptr(),
            caps.data_ptr(), counts)
    _launch("knn_caps", "knn_caps", *ptrs, n, nq, nv, int(k), int(exclude_self))
    _launch("knn_split", "knn", *ptrs, n, nq, nv, int(k), int(exclude_self), s)
    return part


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
        if s == 1:
            boxes = _boxes(points, nv)
            if nv:
                _launch("knn_boxes", "knn_boxes", points.data_ptr(), boxes.data_ptr(), nv)
            _launch("knn", "knn", points.data_ptr(), queries.data_ptr(), d.data_ptr(),
                    idx.data_ptr(), boxes.data_ptr(), _counts(points.device).data_ptr(), n,
                    nq, nv, int(k), int(exclude_self))
        else:
            part = split(points, queries, k, nv, exclude_self, s)
            _launch("knn_merge", "knn_merge", part.data_ptr(), d.data_ptr(), idx.data_ptr(),
                    nq, int(k), s)
    return d, idx


def slice_bounds(nv: int, s: int) -> list[tuple[int, int]]:
    """The kernel's slices of the points [0, nv): ceil(tiles / s) whole
    tiles each."""
    step = -(-(-(-nv // TILE)) // s) * TILE
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


def tile_boxes_plain(points: torch.Tensor, nv: int | None = None, size: int = TILE):
    """``knn_kernel_boxes``: for each run of ``size`` points below ``nv`` (a
    tile, or a chunk at ``size=CHUNK``), the box ``(lo (m, 3), hi (m, 3))``
    of its points with a finite |p|^2 and their largest |p|^2 ``pp`` (m,),
    -1 where there is none (the box then +inf to -inf)."""
    nv = points.shape[0] if nv is None else int(nv)
    p = points[:nv].to(torch.float32)
    pp = (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2] * p[:, 2]
    ok = pp <= torch.finfo(torch.float32).max
    m = -(-nv // size)
    pad = m * size - nv
    ok = torch.nn.functional.pad(ok, (0, pad)).view(m, size)
    p = torch.nn.functional.pad(p, (0, 0, 0, pad)).view(m, size, 3)
    pp = torch.nn.functional.pad(pp, (0, pad)).view(m, size)
    inf = float("inf")
    lo = torch.where(ok[..., None], p, inf).amin(dim=1)
    hi = torch.where(ok[..., None], p, -inf).amax(dim=1)
    return lo, hi, torch.where(ok, pp, -1.0).amax(dim=1)


def needs_plain(queries: torch.Tensor, lim: torch.Tensor, lo, hi, pp) -> torch.Tensor:
    """``knn_needs`` for every (query, box), (nq, m) bool: whether the query,
    at its limit ``lim``, may take a point of the box. A query with no
    finite |q|^2 needs none, a box with no finite point is needed by none;
    past TOP for |q|^2 + |p|^2 every box is needed; else a box is not
    needed where the squared gap from the query to it, lowered by 0.99999
    and by the margin ULPS (|q|^2 + |p|^2) + TINY, exceeds ``lim``."""
    f32 = torch.float32
    q = queries.to(f32)
    qq = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
    s = qq[:, None] + pp[None, :]
    gap = torch.clamp(torch.maximum(lo[None] - q[:, None], q[:, None] - hi[None]), min=0.0)
    lb = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) + gap[..., 2] * gap[..., 2]
    margin = torch.tensor(ULPS, dtype=f32) * s + torch.tensor(TINY, dtype=f32)
    far = (lb * torch.tensor(0.99999, dtype=f32) - margin > lim.to(f32)[:, None]) & (s <= TOP)
    finite = qq <= torch.finfo(f32).max
    return finite[:, None] & (pp[None, :] >= 0) & ~far


def scanned_plain(points: torch.Tensor, queries: torch.Tensor, lim: torch.Tensor,
                  nv: int | None = None) -> torch.Tensor:
    """Which points each query's warp scans outside its home tile at the
    limits ``lim``, (nq, nv) bool: a warp of 32 consecutive queries (the
    kernel's warps below k 2, four such runs a warp at k 1) takes a tile
    where one of its queries needs the tile's box, and scans a chunk of it
    where one of its queries needs the chunk's box."""
    nv = points.shape[0] if nv is None else int(nv)
    nq = queries.shape[0]
    tile = needs_plain(queries, lim, *tile_boxes_plain(points, nv))
    chunk = needs_plain(queries, lim, *tile_boxes_plain(points, nv, CHUNK))

    def warp_any(need):
        pad = -(-nq // 32) * 32 - nq
        grouped = torch.nn.functional.pad(need, (0, 0, 0, pad)).view(-1, 32, need.shape[1])
        return grouped.any(dim=1).repeat_interleave(32, dim=0)[:nq]

    taken = warp_any(tile).repeat_interleave(TILE, dim=1)[:, :nv]
    return taken & warp_any(chunk).repeat_interleave(CHUNK, dim=1)[:, :nv]
