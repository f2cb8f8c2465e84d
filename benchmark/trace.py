"""The traced slice of a ``--trace 1`` run: a few whole jobs under
``torch.profiler``, reduced to what the per-layer readers take.

The device's busy time is the union of its kernel intervals; idle gaps
are the stretches between them, each named by the innermost host
operation that spans its middle. Device groups by kernel name are the
grouping of the program's profiling script, copied here so that the
yardstick stays put.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

LABELLED_GAPS = 300  # the longest gaps, each named by its host operation

# Kernel-name fragments of a group, first match wins.
GROUPS = (("k0", ("k0_kernel", "k0_wide_kernel")),
          ("k1", ("k1_kernel",)),
          ("k2", ("k2_kernel",)),
          ("feature_knn", ("feature_knn_kernel",)),
          ("edge_block", ("edge_block_kernel",)),
          ("knn", ("knn_kernel", "knn_merge_kernel")),
          ("matmul", ("gemm", "cutlass", "cublas", "xmma")),
          ("topk_sort", ("topk", "sort", "radix", "bitonic")),
          ("gather_scatter", ("index", "gather", "scatter")),
          ("reduce", ("reduce",)))


def group(name: str) -> str:
    low = name.lower()
    for g, keys in GROUPS:
        if any(k in low for k in keys):
            return g
    return "elementwise_other"


def union(spans) -> list:
    """Merged (start, end) intervals of ``spans``, sorted."""
    out = []
    for s, t in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def reduce_events(kernels, host_ops, t0: float, t1: float) -> dict:
    """``kernels``: (name, start_us, end_us) of the device; ``host_ops``:
    (name, start_us, end_us) of the host; [t0, t1] the slice in the same
    microseconds. Returns the busy and window seconds, the device time by
    group and by name, and the idle gaps by what the host was doing."""
    merged = union((s, t) for _, s, t in kernels)
    busy = sum(t - s for s, t in merged) / 1e6
    by_group, by_name = defaultdict(float), defaultdict(float)
    for name, s, t in kernels:
        by_group[group(name)] += (t - s) / 1e6
        by_name[name] += (t - s) / 1e6
    edges = [t0] + [x for st in merged for x in st] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    names = [o[0] for o in host_ops]
    starts = np.array([o[1] for o in host_ops], dtype=np.float64)
    ends = np.array([o[2] for o in host_ops], dtype=np.float64)
    idle = defaultdict(float)
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]:
        mid = 0.5 * (s + t)
        cover = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = (names[cover[np.argmin(ends[cover] - starts[cover])]] if cover.size
                else "host (outside any operation)")
        idle[name] += (t - s) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy, "window_s": (t1 - t0) / 1e6, "groups": dict(by_group),
            "by_name": dict(by_name), "kernels": len(kernels),
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)}}


def profile_jobs(run_jobs):
    """Run ``run_jobs()`` under the profiler; returns the reduced slice,
    its window the host clock's time of ``run_jobs``, which ends with the
    device synchronized."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        run_jobs()
        wall = time.perf_counter() - w0
    kernels, host = [], []
    for e in prof.events():
        rng = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                kernels.append(rng)
        else:
            host.append(rng)
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    t0 = min(min(s for _, s, _ in kernels), min((s for _, s, _ in host), default=1e300))
    t1 = max(max(t for _, _, t in kernels), max((t for _, _, t in host), default=0.0))
    out = reduce_events(kernels, host, t0, t1)
    out["window_s"] = wall
    return out
