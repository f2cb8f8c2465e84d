"""Denoising loops on dense ``(N, k)`` neighbourhoods (torch), as
``ngpd_tpu/core/pipeline.py``.

The classical pipeline per iteration:
  1. feature decomposition: kNN(feature_k) -> filtered NVT -> VU-smoothed
     normals -> second filtered NVT;
  2. classify face/edge/corner;
  3. per-class vertex update with the smoothed normals;
  4. adopt the smoothed normals for the next iteration.

On the caller's device (``device=None`` means ``"cuda"``). The
neighbours come from the kNN kernel; ``denoise_iteration`` runs its stages
through ``kernels/dense.py``: on the card as its kernels, sharded callers
included, on the CPU as plain torch. Where the reference scans or loops on
the device (``lax.scan``, ``lax.while_loop``), these functions loop on the
host; ``denoise_until_minimum_error`` reads one scalar a step.

The sharded arguments (``src_*``, ``gather_fn``, ``axis_name``) keep the
reference's names. ``axis_name`` takes a ``torch.distributed`` process
group where the reference takes a mesh axis's name: ``torch.distributed``
runs one process a rank, and its collectives name the group, not an axis
(``parallel/mesh.py::mesh_axis`` gives a mesh axis's group).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..collectives import all_reduce
from ..config import DenoiseConfig
from ..device import exact_float32, resolve_device
from ..kernels import dense as kdense
from ..ops import metrics
from ..ops.knn import estimate_cell_size, knn, knn_grid
from ..ops.neighbors import Neighborhood
from ..ops.steps import STEP_NAMES  # noqa: F401  the reference's module exports it too
from ..utils import prof
from . import voting

DEFAULT_STRATEGY = ("flat", "edge", "feature")


def my_feature_decomposition(points, normals, nbh: Neighborhood, angle: float,
                             vu_tau: float = 0.3, vu_damping: float = 3.0,
                             src_points=None, src_normals=None, src_f_n=None):
    """Filtered NVT, VU-smooth the normals, second filtered NVT on the
    smoothed normals. Returns (Decomposition, smoothed normals).

    Sharded callers pass the whole arrays as ``src_points`` and
    ``src_normals``, and as ``src_f_n`` the whole smoothed normals, so the
    second NVT gathers the same values on every rank."""
    nvt1 = voting.better_filtered_nvt(points, nbh, normals, angle, src_points, src_normals)
    f_n = voting.vu_smoothed_normals(nvt1, normals, vu_tau, vu_damping)
    return voting.better_filtered_nvt(points, nbh, f_n, angle, src_points, src_f_n), f_n


def martin_feature_decomposition(points, normals, nbh: Neighborhood, rho: float = 0.9):
    """The normal-filtered variant on a radius-masked neighbourhood."""
    nvt1 = voting.normal_filtered_nvt(nbh, normals, rho)
    f_n = voting.vu_smoothed_normals(nvt1, normals)
    return voting.normal_filtered_pvt(points, nbh, f_n, rho), f_n


def _class_delta(points, nbh: Neighborhood, row_mask, src_points=None,
                 axis_name=None) -> torch.Tensor:
    """The global neighbour-spread scale restricted to the rows of one
    class: the largest distance of their gathered neighbours from those
    neighbours' mean. With ``axis_name`` (a process group) the sums and the
    maximum run over every rank's rows (``psum`` / ``pmax``), so the scale
    equals the single-device one."""
    vj = nbh.gather(points if src_points is None else src_points)
    m = (row_mask[:, None] & nbh.mask).to(points.dtype)
    vsum = torch.sum(vj * m[..., None], dim=(0, 1))
    total = torch.sum(m)
    if axis_name is not None:
        both = all_reduce(torch.cat([vsum, total[None]]), "sum", axis_name)
        vsum, total = both[:3], both[3]
    center = vsum / torch.clamp(total, min=1.0)
    dist = torch.linalg.norm(vj - center, dim=-1)
    delta = torch.max(torch.where(m > 0, dist, 0.0))
    if axis_name is not None:
        delta = all_reduce(delta, "max", axis_name)
    return delta


def denoise_iteration(
    points: torch.Tensor,
    normals: torch.Tensor,
    nbh_feat: Neighborhood,
    nbh_step: Neighborhood,
    d,
    alphas: tuple[float, float, float],
    angle: float,
    class_scale: float = 0.2,
    strategy: tuple[str, str, str] = DEFAULT_STRATEGY,
    vu_tau: float = 0.3,
    vu_damping: float = 3.0,
    src_points: Optional[torch.Tensor] = None,
    src_normals: Optional[torch.Tensor] = None,
    gather_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    axis_name=None,
):
    """One full classify-and-update iteration for ALL points: each point
    takes the step of its class. Returns (new positions, smoothed normals,
    classes int32).

    The stages run through ``kernels/dense.py``: their plain versions on
    the CPU, one kernel launch each on the card (vote, classify, the class
    deltas' sums and maxima where flat or new is in the strategy, update).

    Sharded mode: ``points`` / ``normals`` hold only this rank's rows,
    ``src_points`` / ``src_normals`` the whole arrays, ``gather_fn``
    gathers a rank-local row array into the whole one, and ``axis_name``
    is the process group of the cross-rank reductions. Single-device
    callers leave all four unset."""
    classes = kdense.delta_classes(strategy)
    with prof.span("ngpd.dense.voting", points.device):
        f_n = kdense.vote(points, normals, nbh_feat, angle, vu_tau, vu_damping, src_points,
                          src_normals)
        src_f_n = gather_fn(f_n) if gather_fn is not None else None
        cls, edge_vectors, parts = kdense.classify(points, f_n, nbh_feat, angle, class_scale,
                                                   nbh_step, classes, src_points, src_f_n)
    with prof.span("ngpd.dense.steps", points.device):
        deltas = kdense.class_deltas(points, nbh_step, cls, classes, parts, src_points,
                                     axis_name)
        new_pos = kdense.update(points, f_n, nbh_step, cls, edge_vectors, deltas, d, alphas,
                                strategy, src_points, src_f_n)
    return new_pos, f_n, cls


def step_threshold(points: torch.Tensor, num_valid=None) -> torch.Tensor:
    """d = 2 * mean 6-NN edge length. Quirk preserved: the 6-NN query
    includes the query itself as a zero-length edge, so the mean runs
    over six distances one of which is 0."""
    nbh, _ = knn(points, 6, num_valid=num_valid)
    return 2.0 * metrics.average_edge_length(points, nbh)


def _on_device(device, *arrays):
    dev = resolve_device(device)
    exact_float32()
    return [torch.as_tensor(a, dtype=torch.float32).to(dev) for a in arrays]


def denoise(
    points,
    normals,
    cfg: DenoiseConfig = DenoiseConfig(),
    strategy: tuple[str, str, str] = DEFAULT_STRATEGY,
    iterations: Optional[int] = None,
    num_valid: Optional[int] = None,
    neighbor_method: str = "auto",
    grid_capacity: int = 96,
    device=None,
):
    """Fixed-iteration denoise. Neighbours are recomputed from the
    current positions every iteration. ``neighbor_method``: "brute"
    (exact, default below 100k points), "grid" (voxel hash) or "auto".

    Returns (denoised points, final normals, final classes) on ``device``.
    """
    if neighbor_method not in ("auto", "brute", "grid"):
        raise ValueError(f"neighbor_method must be auto, brute or grid, got "
                         f"{neighbor_method!r}")
    iters = cfg.iterations if iterations is None else iterations
    if iters < 1:
        raise ValueError("denoise needs at least one iteration")
    pos, nrm = _on_device(device, points, normals)
    dev = pos.device
    use_grid = neighbor_method == "grid" or (
        neighbor_method == "auto" and pos.shape[0] >= 100_000)
    with prof.span("ngpd.dense", dev):
        with prof.span("ngpd.dense.step_threshold", dev):
            d = cfg.d_scale / 2.0 * step_threshold(pos, num_valid)
        if use_grid:
            # Cell sized for the largest k in play, estimated once on the
            # noisy input (positions only shrink toward the surface).
            cell = estimate_cell_size(pos, max(cfg.feature_k, cfg.step_k))

            def neighbors(p, k):
                return knn_grid(p, k, cell, capacity=grid_capacity, num_valid=num_valid)[0]
        else:

            def neighbors(p, k):
                return knn(p, k, num_valid=num_valid)[0]

        cls = None
        for _ in range(iters):
            with prof.span("ngpd.dense.neighbors", dev):
                nbh_feat, nbh_step = neighbors(pos, cfg.feature_k), neighbors(pos, cfg.step_k)
            pos, nrm, cls = denoise_iteration(
                pos, nrm, nbh_feat, nbh_step, d, cfg.alphas, cfg.angle, cfg.class_scale,
                strategy, cfg.vu_tau, cfg.vu_damping)
    return pos, nrm, cls


def _mean_error(error_fn, gt, pos) -> float:
    return float(torch.mean(error_fn(gt, pos)))


def denoise_until_minimum_error(
    points,
    normals,
    gt_points,
    cfg: DenoiseConfig = DenoiseConfig(),
    strategy: tuple[str, str, str] = DEFAULT_STRATEGY,
    k: int = 7,
    alphas: tuple[float, float, float] = (0.02, 0.02, 0.1),
    d: float = 200.0,
    error_fn: Callable = metrics.paper_distance,
    max_iterations: Optional[int] = None,
    device=None,
):
    """Iterate while the error against GT keeps improving; return the
    previous iterate, its error and ``iterations - 1``, exactly as the
    reference's while loop leaves them (also when ``max_iterations`` ends
    the loop). The error is read on the host once a step.

    Returns (points, normals, error_mean, iterations_done).
    """
    max_iters = cfg.max_iterations if max_iterations is None else max_iterations
    pos, nrm, gt = _on_device(device, points, normals, gt_points)
    d_arr = torch.as_tensor(d, dtype=pos.dtype, device=pos.device)
    err0 = _mean_error(error_fn, gt, pos)
    # The reference's carry: the previous iterate starts as the input with
    # error err0 + 200.
    prev_pos, prev_nrm, prev_err = pos, nrm, err0 + 200.0
    cur_err, it = err0, 0
    while cur_err < prev_err and it < max_iters:
        new_pos, f_n, _ = denoise_iteration(
            pos, nrm, knn(pos, cfg.feature_k)[0], knn(pos, k)[0], d_arr, alphas,
            cfg.angle, cfg.class_scale, strategy, cfg.vu_tau, cfg.vu_damping)
        prev_pos, prev_nrm, prev_err = pos, nrm, cur_err
        pos, nrm, cur_err = new_pos, f_n, _mean_error(error_fn, gt, new_pos)
        it += 1
    return prev_pos, prev_nrm, prev_err, it - 1


def denoise_until_minimum_error_windowed(
    points,
    normals,
    gt_points,
    cfg: DenoiseConfig = DenoiseConfig(),
    strategy: tuple[str, str, str] = DEFAULT_STRATEGY,
    max_iterations: int = 64,
    error_fn: Callable = metrics.paper_distance,
    tile: int = 256,
    window: int = 256,
    use_pallas: Optional[bool] = None,
    device=None,
):
    """Until-minimum-error loop at large-cloud scale: each step is one
    iteration of a windowed engine and the error check loops on the host.
    ``use_pallas`` keeps the reference's name: true steps with the hybrid
    engine (K0, K1 and K2 once each), false with ``fused_denoise`` on
    thresholds computed once a step (``threshold_refresh=0``), and None
    picks the hybrid on the card and ``fused_denoise`` on the CPU, as the
    reference picks its Pallas engine on its accelerator.

    Returns (best_points, best_normals, best_error_mean, iterations_done).
    """
    from .cuda_fused import denoise_hybrid
    from .fused import fused_denoise

    pos, nrm, gt = _on_device(device, points, normals, gt_points)
    if use_pallas is None:
        use_pallas = pos.device.type == "cuda"

    def step(p, n):
        if use_pallas:
            return denoise_hybrid(p, n, cfg, strategy=strategy, iterations=1, tile=tile,
                                  window=window, device=p.device)
        return fused_denoise(p, n, cfg, strategy=strategy, iterations=1, tile=tile,
                             window=window, threshold_refresh=0, device=p.device)

    prev_pos, prev_nrm = pos, nrm
    prev_err = _mean_error(error_fn, gt, pos)
    it = 0
    while it < max_iterations:
        new_pos, new_nrm, _ = step(pos, nrm)
        err = _mean_error(error_fn, gt, new_pos)
        if err >= prev_err:
            break
        prev_pos, prev_nrm, prev_err = new_pos, new_nrm, err
        pos, nrm = new_pos, new_nrm
        it += 1
    return prev_pos, prev_nrm, prev_err, it
