"""Arithmetic the metric readers share. A reader takes the run's record:
``setup_s``; ``window`` (its ``start`` and ``end`` on the host clock, the
``units`` of work a job does, and every whole ``jobs`` entry with its
``start`` and ``end``); ``work`` (the job's least work, from
``benchmark/counts``); and ``trace`` (the traced slice of a ``--trace 1``
run, reduced by ``benchmark/trace.py``, with the program's launch
``counters`` over it; None otherwise). A reader that finds nothing to read
returns None."""

from __future__ import annotations

import math

from .counts import peaks


def rate(rec) -> float:
    """Units of every whole job of the window over the time from the
    window's start to the end of its last job."""
    w = rec["window"]
    return w["units"] * len(w["jobs"]) / (w["end"] - w["start"])


def p95_ms(rec) -> float:
    """The 95th percentile of every job's latency (nearest rank), ms."""
    lat = sorted(j["end"] - j["start"] for j in rec["window"]["jobs"])
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]


def mfu_percent(rec) -> float | None:
    """The window's least operations over its time, as a share of the
    chip's float32 peak."""
    flop = rec["work"].get("flop")
    if not flop:
        return None
    w = rec["window"]
    return 100.0 * flop * len(w["jobs"]) / (w["end"] - w["start"]) / peaks.FLOPS


def group_seconds(rec, *groups) -> float:
    return sum(rec["trace"]["groups"].get(g, 0.0) for g in groups)


def counted(rec, name: str, per_job: int) -> bool:
    """Whether the program's counter ``name`` counted ``per_job`` launches
    for every traced job."""
    t = rec["trace"]
    return t["counters"].get(name, -1) == per_job * t["jobs"]


def roofline_percent(least_per_job: float, rec, *groups) -> float | None:
    """The least time of the traced jobs' launches over the device time of
    those kernels, in percent."""
    if rec["trace"] is None:
        return None
    spent = group_seconds(rec, *groups)
    if spent <= 0.0 or least_per_job <= 0.0:
        return None
    return 100.0 * least_per_job * rec["trace"]["jobs"] / spent


def idle_percent(rec) -> float | None:
    t = rec["trace"]
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def knn_roofline(rec) -> float | None:
    """The least time of the job's kNN searches (``work["knn"]``) over the
    kNN kernels' device time, where the program made exactly those
    searches."""
    w, t = rec["work"], rec["trace"]
    if t is None or not w.get("knn") or not counted(rec, "knn", len(w["knn"])):
        return None
    return roofline_percent(peaks.least_seconds(0.0, w["knn_bytes"]), rec, "knn")
