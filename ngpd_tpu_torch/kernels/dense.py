"""The dense pipeline's per-iteration stages as CUDA kernels: wrappers over
``csrc/dense_vote.cu``, ``csrc/dense_classify.cu``, ``csrc/dense_sums.cu``,
``csrc/dense_delta.cu`` and ``csrc/dense_update.cu``, and their plain
versions.

``core/pipeline.py::denoise_iteration`` runs its stages through these
wrappers on every device. A wrapper given CPU tensors runs its plain
version (``*_plain``: ``core/voting.py``'s filtered NVT, VU smoothing and
classes, ``core/pipeline.py::_class_delta`` and the steps of
``core/denoise.py``); given CUDA tensors it launches its kernel on the
current stream and adds one to ``LAUNCHES[name]``; anything else raises.
There is no fallback from a kernel to the plain versions.

Sharded callers pass the source rows that the neighbour indices name
(``src_points``, ``src_normals``, ``src_f_n``: the whole cloud's) and, for
the class deltas, the process group of the cross-rank reductions
(``axis_name``); both default to one device's arrays.

On the card the kernels give the plain versions' bits (sums in PyTorch's
order, ``csrc/dense_common.cuh``, for up to ``MAX_K`` neighbours a row),
but for the flat and new steps' class deltas, whose centres
``dense_classify`` sums per block and ``dense_sums`` over the blocks: a
delta may differ by a few ulps. The deltas travel as per-block maxima (3,
blocks), a class's delta the largest of its row, which ``update`` reduces
on the card; the plain version, and a sharded caller after its all-reduce,
give one column.
"""

from __future__ import annotations

import torch

from ..collectives import all_reduce
from ..core import denoise as steps
from ..core import voting
from ..ops.neighbors import Neighborhood
from ..ops.steps import STEP_NAMES
from . import window as kw

LAUNCHES = {"dense_vote": 0, "dense_classify": 0, "dense_sums": 0, "dense_delta": 0,
            "dense_update": 0}
THREADS = 128  # points a block of every dense kernel: one column of the partials
MAX_K = 127  # neighbours a row that the kernels sum in PyTorch's CUDA orders
DELTA_STEPS = ("flat", "new")


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def delta_classes(strategy) -> tuple:
    """The classes whose step needs a class delta (flat and new)."""
    return tuple(c for c in range(3) if strategy[c] in DELTA_STEPS)


def _dmask(classes) -> int:
    if any(c not in (0, 1, 2) for c in classes):
        raise ValueError(f"delta classes must be among 0, 1, 2, got {classes}")
    return sum(1 << c for c in set(classes))


def _on_cuda(rows: dict, nbhs: dict, sources: dict = None) -> bool:
    """Validate (N, 3) ``rows`` and (N, k) neighbourhoods ``nbhs`` of one
    point count, and (M, 3) ``sources`` (None: unset), all on one device;
    True when that is a CUDA device, where each must also be float32, a
    neighbourhood's indices int64 and its mask bool."""
    dev, n = None, None
    sources = {k: v for k, v in (sources or {}).items() if v is not None}
    for name, x in {**rows, **sources}.items():
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be (rows, 3), got {tuple(x.shape)}")
        if name in rows:
            if n is not None and x.shape[0] != n:
                raise ValueError(f"{name} has {x.shape[0]} rows, the other operands {n}")
            n = x.shape[0]
        if dev is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the other operands on {dev}")
        dev = x.device
    for name, (idx, mask) in nbhs.items():
        if idx.dim() != 2 or tuple(mask.shape) != tuple(idx.shape):
            raise ValueError(f"{name} must hold (N, k) indices and a mask of their shape, got "
                             f"{tuple(idx.shape)} and {tuple(mask.shape)}")
        if idx.shape[0] != n:
            raise ValueError(f"{name} has {idx.shape[0]} rows, the points {n}")
        if idx.device != dev or mask.device != dev:
            raise ValueError(f"{name} is on {idx.device}, the other operands on {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"the dense stage kernels run on cuda or cpu, not {dev}")
    for name, x in {**rows, **sources}.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on the card, got {x.dtype}")
    for name, (idx, mask) in nbhs.items():
        if idx.dtype != torch.int64 or mask.dtype != torch.bool:
            raise TypeError(f"{name} must hold int64 indices and a bool mask on the card, got "
                            f"{idx.dtype} and {mask.dtype}")
    return True


def _blocks(n: int) -> int:
    return -(-n // THREADS)


def _dense(nbh: Neighborhood) -> Neighborhood:
    return Neighborhood(nbh.idx.contiguous(), nbh.mask.contiguous())


def vote_plain(points, normals, nbh: Neighborhood, angle: float, vu_tau: float,
               vu_damping: float, src_points=None, src_normals=None) -> torch.Tensor:
    nvt1 = voting.better_filtered_nvt(points, nbh, normals, angle, src_points, src_normals)
    return voting.vu_smoothed_normals(nvt1, normals, vu_tau, vu_damping)


def vote(points: torch.Tensor, normals: torch.Tensor, nbh: Neighborhood, angle: float,
         vu_tau: float, vu_damping: float, src_points=None, src_normals=None) -> torch.Tensor:
    """The VU-smoothed normals (N, 3) of the first filtered NVT over ``nbh``."""
    if not _on_cuda({"points": points, "normals": normals}, {"nbh": nbh},
                    {"src_points": src_points, "src_normals": src_normals}):
        return vote_plain(points, normals, nbh, angle, vu_tau, vu_damping, src_points,
                          src_normals)
    pts, nrm, nbh = points.contiguous(), normals.contiguous(), _dense(nbh)
    sp = pts if src_points is None else src_points.contiguous()
    sn = nrm if src_normals is None else src_normals.contiguous()
    f_n = torch.empty_like(pts)
    kw.launch("dense_vote", LAUNCHES, pts.data_ptr(), nrm.data_ptr(), sp.data_ptr(),
              sn.data_ptr(), nbh.idx.data_ptr(), nbh.mask.data_ptr(), pts.shape[0], nbh.k,
              float(angle), float(vu_tau), float(vu_damping), f_n.data_ptr())
    return f_n


def classify_plain(points, f_n, nbh_feat: Neighborhood, angle: float, class_scale: float,
                   src_points=None, src_f_n=None):
    decomp = voting.better_filtered_nvt(points, nbh_feat, f_n, angle, src_points, src_f_n)
    return voting.classes(decomp, class_scale), decomp.eigvec[..., 0]


def classify(points: torch.Tensor, f_n: torch.Tensor, nbh_feat: Neighborhood, angle: float,
             class_scale: float, nbh_step: Neighborhood, classes=(), src_points=None,
             src_f_n=None):
    """(classes (N,) int32, edge directions (N, 3), partials) of the second
    filtered NVT over ``nbh_feat`` of the smoothed normals (``src_f_n``
    the rows its indices name, ``f_n`` by default). On the card the
    partials (12, blocks) are the centre sums of the delta ``classes`` over
    ``nbh_step``, which ``class_deltas`` reads; the plain version has none
    (None)."""
    dmask = _dmask(classes)
    if not _on_cuda({"points": points, "f_n": f_n},
                    {"nbh_feat": nbh_feat, "nbh_step": nbh_step},
                    {"src_points": src_points, "src_f_n": src_f_n}):
        return (*classify_plain(points, f_n, nbh_feat, angle, class_scale, src_points,
                                src_f_n), None)
    pts, nf, ns = points.contiguous(), _dense(nbh_feat), _dense(nbh_step)
    sp = pts if src_points is None else src_points.contiguous()
    sf = f_n.contiguous() if src_f_n is None else src_f_n.contiguous()
    n = pts.shape[0]
    cls = torch.empty(n, dtype=torch.int32, device=pts.device)
    edge = torch.empty_like(pts)
    parts = torch.empty((12, _blocks(n)), dtype=torch.float32, device=pts.device)
    kw.launch("dense_classify", LAUNCHES, pts.data_ptr(), sp.data_ptr(), sf.data_ptr(),
              nf.idx.data_ptr(), nf.mask.data_ptr(), nf.k, ns.idx.data_ptr(),
              ns.mask.data_ptr(), ns.k, n, float(angle), float(class_scale), dmask,
              cls.data_ptr(), edge.data_ptr(), parts.data_ptr())
    return cls, edge, parts


def _check_classes(cls: torch.Tensor, n: int, dev) -> None:
    if cls.dtype != torch.int32 or tuple(cls.shape) != (n,) or cls.device != dev:
        raise ValueError(f"cls must be ({n},) int32 on {dev}, got {cls.dtype} "
                         f"{tuple(cls.shape)} on {cls.device}")


def class_deltas_plain(points, nbh_step: Neighborhood, cls, classes, src_points=None,
                       axis_name=None) -> torch.Tensor:
    from ..core.pipeline import _class_delta  # the pipeline imports this module

    zero = torch.zeros((), dtype=points.dtype, device=points.device)
    return torch.stack([_class_delta(points, nbh_step, cls == c, src_points, axis_name)
                        if c in classes else zero for c in range(3)])[:, None]


def class_deltas(points: torch.Tensor, nbh_step: Neighborhood, cls: torch.Tensor, classes,
                 parts=None, src_points=None, axis_name=None) -> torch.Tensor:
    """The flat and new steps' deltas of ``classes`` as (3, columns): class
    c's delta is the largest of row c, 0 outside ``classes``. The plain
    version gives one column; the kernels one column a block of points,
    or with ``axis_name`` (a process group) one column reduced over every
    rank's rows, as ``_class_delta`` reduces its sums and maximum."""
    dmask = _dmask(classes)
    if not _on_cuda({"points": points}, {"nbh_step": nbh_step}, {"src_points": src_points}):
        return class_deltas_plain(points, nbh_step, cls, classes, src_points, axis_name)
    n = points.shape[0]
    _check_classes(cls, n, points.device)
    blocks = _blocks(n)
    if not (isinstance(parts, torch.Tensor) and tuple(parts.shape) == (12, blocks)
            and parts.dtype == torch.float32 and parts.device == points.device
            and parts.is_contiguous()):
        raise ValueError(f"parts must be classify's (12, {blocks}) float32 partials")
    if not dmask:
        return torch.zeros((3, 1), dtype=torch.float32, device=points.device)
    ns, cls = _dense(nbh_step), cls.contiguous()
    sp = points.contiguous() if src_points is None else src_points.contiguous()
    sums = torch.empty(12, dtype=torch.float32, device=points.device)
    kw.launch("dense_sums", LAUNCHES, parts.data_ptr(), blocks, dmask, sums.data_ptr())
    if axis_name is not None:
        sums = all_reduce(sums, "sum", axis_name)
    deltas = torch.empty((3, blocks), dtype=torch.float32, device=points.device)
    kw.launch("dense_delta", LAUNCHES, sp.data_ptr(), ns.idx.data_ptr(), ns.mask.data_ptr(),
              ns.k, cls.data_ptr(), sums.data_ptr(), n, dmask, deltas.data_ptr())
    if axis_name is not None:
        deltas = all_reduce(deltas.amax(dim=1, keepdim=True), "max", axis_name)
    return deltas


def _threshold(d, dev):
    """(pointer, value) of the step threshold: a one-element float32 tensor
    on the card is read there, a number is passed by value."""
    if isinstance(d, torch.Tensor):
        if d.numel() != 1 or d.dtype != torch.float32 or d.device != dev:
            raise ValueError(f"d must be one float32 on {dev} or a number, got {d.dtype} "
                             f"{tuple(d.shape)} on {d.device}")
        return d.data_ptr(), 0.0
    return None, float(d)


def update_plain(points, f_n, nbh_step: Neighborhood, cls, edge_vectors, deltas, d, alphas,
                 strategy, src_points=None, src_f_n=None) -> torch.Tensor:
    classes = delta_classes(strategy)
    results = [steps.class_step(strategy[c], points, nbh_step, f_n, edge_vectors, d, alphas[c],
                                deltas[c].amax() if c in classes else None,
                                src_points=src_points, src_normals=src_f_n)
               for c in range(3)]
    return steps.pick_by_class(cls, results)


def update(points: torch.Tensor, f_n: torch.Tensor, nbh_step: Neighborhood, cls: torch.Tensor,
           edge_vectors: torch.Tensor, deltas: torch.Tensor, d, alphas, strategy,
           src_points=None, src_f_n=None) -> torch.Tensor:
    """The new positions (N, 3): each point takes the step of its class
    (``strategy[cls]``, size ``alphas[cls]``) over ``nbh_step`` with the
    smoothed normals ``f_n`` (``src_f_n`` the rows its indices name); flat
    and new with their class's delta (the largest of its row of
    ``deltas``), edge along ``edge_vectors``; a step that reaches ``d`` is
    dropped."""
    kinds = tuple(STEP_NAMES.index(s) if s in STEP_NAMES else -1 for s in strategy)
    if len(kinds) != 3 or -1 in kinds:
        raise ValueError(f"unknown step in {strategy!r}; expected three of {STEP_NAMES}")
    if not _on_cuda({"points": points, "f_n": f_n, "edge_vectors": edge_vectors},
                    {"nbh_step": nbh_step}, {"src_points": src_points, "src_f_n": src_f_n}):
        return update_plain(points, f_n, nbh_step, cls, edge_vectors, deltas, d, alphas,
                            strategy, src_points, src_f_n)
    n = points.shape[0]
    _check_classes(cls, n, points.device)
    if not (deltas.dim() == 2 and deltas.shape[0] == 3 and deltas.shape[1] >= 1
            and deltas.dtype == torch.float32 and deltas.device == points.device
            and deltas.is_contiguous()):
        raise ValueError(f"deltas must be a contiguous (3, columns) float32 tensor on "
                         f"{points.device}")
    d_ptr, d_val = _threshold(d, points.device)
    pts, fn, ns = points.contiguous(), f_n.contiguous(), _dense(nbh_step)
    cls, edge = cls.contiguous(), edge_vectors.contiguous()
    sp = pts if src_points is None else src_points.contiguous()
    sf = fn if src_f_n is None else src_f_n.contiguous()
    out = torch.empty_like(pts)
    kw.launch("dense_update", LAUNCHES, pts.data_ptr(), fn.data_ptr(), sp.data_ptr(),
              sf.data_ptr(), ns.idx.data_ptr(), ns.mask.data_ptr(), ns.k, cls.data_ptr(),
              edge.data_ptr(), deltas.data_ptr(), deltas.shape[1],
              _dmask(delta_classes(strategy)), d_ptr, d_val, *kinds,
              *(float(a) for a in alphas), n, out.data_ptr())
    return out
