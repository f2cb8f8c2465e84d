"""Profiling and timing harness, as ``ngpd_tpu/utils/prof.py``.

  * ``profile_trace`` — a ``torch.profiler`` trace of a block (CPU
    activities, and CUDA ones where a card is present), written as a Chrome
    trace that Perfetto or ``chrome://tracing`` opens;
  * ``time_fn`` — the best wall time over repeats after warm-up calls,
    synchronising the card when the result holds a CUDA tensor;
  * ``Timer`` — a context-manager stopwatch for host phases;
  * ``span`` — a named stage of the port's own layers, recorded only while
    a ``torch.profiler`` session records: on the profiler's clock (a user
    annotation beside the kernels), in a registry with its parent and its
    root's call, and on a card as a CUDA event pair; ``recorded()`` sums
    them by name.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from .cache import cache_dir

MAX_RECORDS = 1_000_000  # spans kept; the rest are counted as dropped


class _Record:
    __slots__ = ("name", "parent", "call", "t0", "t1", "child_ns", "events", "device")

    def __init__(self, name: str, parent: Optional["_Record"], call: int):
        self.name, self.call = name, call
        self.parent = None if parent is None else parent.name
        self.t0 = self.t1 = self.child_ns = 0
        self.events = self.device = None


class _Registry:
    """The spans of the current recording stretch. ``stale``: a span ran
    while nothing recorded, so the next recorded root starts afresh."""

    def __init__(self):
        self.records = []  # _Record, in the order they opened
        self.open = []  # the open spans' records, innermost last
        self.calls = 0
        self.dropped = 0
        self.stale = False


_REGISTRY = _Registry()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "rec", "fn")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        reg = _REGISTRY
        if reg.stale and not reg.open:
            reg.stale = False
            reg.records, reg.dropped = [], 0
        parent = reg.open[-1] if reg.open else None
        if parent is None:
            reg.calls += 1
        rec = _Record(self.name, parent, reg.calls if parent is None else parent.call)
        if len(reg.records) < MAX_RECORDS:
            reg.records.append(rec)
            dev = None if self.device is None else torch.device(self.device)
            if dev is not None and dev.type == "cuda":
                rec.events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                rec.device = dev
        else:
            reg.dropped += 1
        reg.open.append(rec)
        self.rec = rec
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        if rec.events is not None:
            rec.events[0].record(torch.cuda.current_stream(rec.device))
        rec.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1 = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(rec.device))
        self.fn.__exit__(*exc)
        reg = _REGISTRY
        reg.open.pop()
        if reg.open:
            reg.open[-1].child_ns += rec.t1 - rec.t0
        return False


def span(name: str, device=None):
    """A context manager for one stage of the port, named ``name``.

    While no ``torch.profiler`` session records, it does nothing (a flag
    read and a shared no-op object). While one records, it opens
    ``torch.profiler.record_function(name)`` and keeps a record (its
    parent span, its root's call id, host start and end); where
    ``device`` is a CUDA device, it also records a CUDA event pair on that
    device's current stream around the stage. The first recorded span
    after spans that ran unrecorded starts the records afresh. Spans nest
    on one thread."""
    if not _autograd_profiler._is_profiler_enabled:
        _REGISTRY.stale = True
        return _OFF
    return _Span(name, device)


def recorded() -> dict:
    """Per-name totals of the recorded spans: ``{"spans": {name: {"count",
    "host_ms", "self_ms", "stream_ms"}}, "dropped": n}``. ``host_ms`` is
    the host clock's time inside the span, ``self_ms`` that time less its
    direct children's, ``stream_ms`` the time between its CUDA events (the
    stage's device time with any idle left inside it; None for spans that
    recorded no events). Synchronises each card that recorded events,
    once, to read them."""
    recs = [r for r in _REGISTRY.records if r.t1]  # the closed ones
    for dev in {r.device for r in recs if r.device is not None}:
        torch.cuda.synchronize(dev)
    out = {}
    for r in recs:
        s = out.setdefault(r.name, {"count": 0, "host_ms": 0.0, "self_ms": 0.0,
                                    "stream_ms": None})
        s["count"] += 1
        s["host_ms"] += (r.t1 - r.t0) / 1e6
        s["self_ms"] += (r.t1 - r.t0 - r.child_ns) / 1e6
        if r.events is not None:
            s["stream_ms"] = (s["stream_ms"] or 0.0) + r.events[0].elapsed_time(r.events[1])
    return {"spans": out, "dropped": _REGISTRY.dropped}


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
