"""One run of one cell: set-up, a closed-loop window of jobs, the traced
slice, the comparison with the plain reference, and the result line.

The loop has one client: each job starts when the last has ended, with
the device synchronized, so a job's latency is its service time. The
window's jobs take the pool's inputs in turn; every output is kept until
the window has closed. A traced run then profiles a few more jobs. Then a sample of the jobs, drawn from the seed,
one for each distinct input the sample reaches, is compared with the
reference, computed once per input after the program's state is freed.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from . import catalog, trace
from .gen import pool

FORBIDDEN = ("jax", "jaxlib", "flax", "ngpd_tpu")


def loaded_forbidden(modules=None) -> list:
    """Modules whose top-level name is one of ``FORBIDDEN``, compared
    whole: ``ngpd_tpu_torch`` is not ``ngpd_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sample_jobs(jobs: list, pool_size: int, count: int, seed: int) -> list:
    """``count`` job ids drawn from the seed among the window's jobs, each
    with another input where the pool allows; the jobs' ids in order."""
    rng = np.random.default_rng(int(seed) % (1 << 63) + 1)
    ids = [j["id"] for j in jobs]
    rng.shuffle(ids)
    chosen, inputs = [], set()
    for i in ids:
        if i % pool_size not in inputs:
            chosen.append(i)
            inputs.add(i % pool_size)
        if len(chosen) == count:
            break
    return sorted(chosen)


def latency_summary(jobs: list) -> dict:
    """Quartiles and extremes of the jobs' latencies, and the first few."""
    lat = [j["end"] - j["start"] for j in jobs]
    if not lat:
        return {}
    q = np.quantile(lat, [0.0, 0.25, 0.5, 0.75, 1.0])
    return {"n": len(lat), "min": q[0], "p25": q[1], "median": q[2], "p75": q[3],
            "max": q[4], "first": lat[:5]}


def run_cell(cell: catalog.Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, faults=None) -> dict:
    """The run's record: metrics, checks, device, jobs. ``t_start`` is the
    host clock when the run's process began its work; set-up ends with the
    first job of the window. ``faults`` (tests only) wraps the timed
    path."""
    if cell.traffic.get("loop", "closed") != "closed" or int(cell.traffic.get("clients", 1)) != 1:
        raise ValueError("the harness runs a closed loop with one client")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    marks = [time.perf_counter()]
    inputs = pool.make_pool(cell.traffic, seed, dev)
    sync(dev)
    marks.append(time.perf_counter())
    system = cell.entry.System(cell.config, cell.traffic, dev)
    run = system.run if faults is None else faults(system.run)
    marks.append(time.perf_counter())
    run(inputs[0])  # warm-up: every shape of the mix, kernels built and loaded
    sync(dev)
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t_start
    setup_parts = {k: b - a for k, a, b in zip(("start", "inputs", "system", "warm_up"),
                                                [t_start] + marks[:-1], marks)}

    jobs, outputs, failed = [], {}, 0
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        i = len(jobs)
        ts = time.perf_counter()
        try:
            outputs[i] = run(inputs[i % len(inputs)])
            sync(dev)
        except Exception as exc:  # a job that fails ends the window
            print(f"job {i} failed: {exc!r}", file=sys.stderr)
            failed += 1
            jobs.append({"id": i, "start": ts, "end": time.perf_counter(), "failed": True})
            break
        jobs.append({"id": i, "start": ts, "end": time.perf_counter()})
    window = {"start": w0, "end": jobs[-1]["end"], "units": system.units(),
              "jobs": [j for j in jobs if not j.get("failed")]}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # The traced slice: a few more jobs under the profiler, once the
    # window has closed, so that the window's metrics are a plain run's.
    sliced = None
    if traced and not failed:
        n_jobs = int(cell.traffic.get("trace_jobs", 1))
        c0 = dict(system.counters())

        def slice_jobs():
            for j in range(len(jobs), len(jobs) + n_jobs):
                run(inputs[j % len(inputs)])
                sync(dev)

        sliced = trace.profile_jobs(slice_jobs)
        c1 = system.counters()
        sliced["counters"] = {k: c1[k] - c0.get(k, 0) for k in c1}
        sliced["jobs"] = n_jobs

    # Correctness, once the window has closed: the sample's outputs, the
    # program's state freed, the reference once per input.
    ok_jobs = [j for j in jobs if not j.get("failed")]
    sample = sample_jobs(ok_jobs, len(inputs), int(cell.traffic["sample"]), seed)
    kept = {i: tuple(t.detach() for t in outputs[i]) for i in sample}
    outputs.clear()
    work = system.work()
    del system, run
    numbers = {}
    for i in sample:
        ref = cell.entry.reference(cell.config, cell.traffic, inputs[i % len(inputs)])
        for k, v in cell.entry.compare(kept[i], ref).items():
            numbers[k] = max(numbers.get(k, -math.inf), v)
        del ref
    checks = {k: {"value": numbers.get(k, math.inf), "limit": lim}
              for k, lim in cell.limits.items()}
    correct = (failed == 0 and bool(sample)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    rec = {"setup_s": setup_s, "window": window, "trace": sliced, "work": work}
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = catalog.reader("layer_metrics" if traced else "end_to_end", m["name"],
                               cell.bench_dir)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(jobs), "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                      "count": cell.chips, "memory_peak_bytes": int(peak)},
           "sample": sample, "numbers": numbers, "setup_parts_s": setup_parts,
           "latency_s": latency_summary(window["jobs"])}
    if sliced is not None:
        out["device"]["busy_s"] = sliced["busy_s"]
        out["device"]["window_s"] = sliced["window_s"]
        out["breakdown"] = sliced["breakdown"]
    out["checks"] = checks
    return out
