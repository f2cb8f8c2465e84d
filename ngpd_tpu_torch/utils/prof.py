"""Profiling and timing harness, as ``ngpd_tpu/utils/prof.py``.

  * ``profile_trace`` — a ``torch.profiler`` trace of a block (CPU
    activities, and CUDA ones where a card is present), written as a Chrome
    trace that Perfetto or ``chrome://tracing`` opens;
  * ``time_fn`` — the best wall time over repeats after warm-up calls,
    synchronising the card when the result holds a CUDA tensor;
  * ``Timer`` — a context-manager stopwatch for host phases.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from .cache import cache_dir


class Timer:
    def __init__(self, name: str = "", verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"[{self.name}] {self.elapsed:.3f}s")


def _leaves(x):
    """The leaves of nested tuples, lists and dicts, as
    ``jax.tree_util.tree_leaves`` walks them."""
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    else:
        yield x


def _sync(x):
    if any(isinstance(leaf, torch.Tensor) and leaf.is_cuda for leaf in _leaves(x)):
        torch.cuda.synchronize()
    return x


def time_fn(fn: Callable, *args, repeats: int = 3, warmup: int = 1, **kw) -> float:
    """Best wall-clock seconds over ``repeats`` calls after ``warmup``
    calls; each call ends in ``torch.cuda.synchronize()`` when its result
    holds a CUDA tensor."""
    for _ in range(warmup):
        _sync(fn(*args, **kw))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(fn(*args, **kw))
        best = min(best, time.perf_counter() - t0)
    return best


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Trace a block with ``torch.profiler`` and write it as a Chrome trace
    ``trace_<pid>_<ns>.json`` into ``log_dir`` (default ``trace/`` in the
    build cache, ``utils/cache.py``); yields ``log_dir``. CUDA activities
    are traced where a card is present."""
    log_dir = str(cache_dir() / "trace") if log_dir is None else str(log_dir)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
