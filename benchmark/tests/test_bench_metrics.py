"""The end-to-end and per-layer arithmetic on synthetic records."""

from __future__ import annotations

import pytest

from benchmark import catalog, readers, trace
from benchmark.counts import peaks


def job_log(latencies, start=100.0, gap=0.0):
    jobs, t = [], start
    for i, lat in enumerate(latencies):
        jobs.append({"id": i, "start": t, "end": t + lat})
        t += lat + gap
    return {"start": start, "end": jobs[-1]["end"], "units": 1000, "jobs": jobs}


def test_a_stall_shows_in_the_rate_and_the_tail():
    steady = job_log([0.02] * 100)
    stalled = job_log([0.02] * 99 + [1.0])
    assert readers.rate({"window": steady}) == pytest.approx(1000 * 100 / 2.0)
    assert readers.rate({"window": stalled}) == pytest.approx(1000 * 100 / 2.98)
    # Ten stalls of 100: nearest rank 95 lies among them.
    tail = job_log([0.02] * 90 + [0.5] * 10)
    assert readers.p95_ms({"window": tail}) == pytest.approx(500.0)
    assert readers.p95_ms({"window": stalled}) == pytest.approx(20.0)
    # Time between jobs counts too: the rate runs from the window's start.
    gaps = job_log([0.02] * 10, gap=0.08)
    assert readers.rate({"window": gaps}) == pytest.approx(1000 * 10 / (0.02 * 10 + 0.08 * 9))


def test_the_end_to_end_readers_are_the_arithmetic():
    rec = {"setup_s": 12.5, "window": job_log([0.02] * 40 + [0.04] * 10)}
    assert catalog.reader("end_to_end", "setup_s")(rec) == 12.5
    assert catalog.reader("end_to_end", "denoise_rate")(rec) == readers.rate(rec)
    assert catalog.reader("end_to_end", "mesh_rate")(rec) == readers.rate(rec)
    assert catalog.reader("end_to_end", "cloud_p95_ms")(rec) == pytest.approx(40.0)


def test_busy_time_is_the_union_of_kernel_intervals_and_gaps_are_named_by_the_host():
    kernels = [("a_kernel", 0.0, 10.0), ("b_gemm", 5.0, 20.0), ("k2_kernel", 30.0, 40.0)]
    host = [("run", -5.0, 60.0), ("aten::nonzero", 21.0, 29.0), ("cudaLaunchKernel", 41, 45)]
    out = trace.reduce_events(kernels, host, -5.0, 50.0)
    assert out["busy_s"] == pytest.approx(30e-6)
    assert out["groups"]["matmul"] == pytest.approx(15e-6)
    assert out["groups"]["k2"] == pytest.approx(10e-6)
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["aten::nonzero"] == pytest.approx(10e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["run"] == pytest.approx(5e-6)  # before the first kernel
    assert out["breakdown"]["device_ops"][0] == ["b_gemm", pytest.approx(15e-6)]


def traced(groups, counters, jobs=2, busy=0.5, window=1.0, kernels=100):
    return {"groups": groups, "counters": counters, "jobs": jobs, "busy_s": busy,
            "window_s": window, "kernels": kernels}


def test_per_layer_readers_divide_by_the_traced_jobs_and_check_the_counters():
    work = {"flop": 6.7e12, "knn": [(1000, 8), (1000, 8)], "knn_bytes": 2 * (12000 + 64000),
            "window": [("k0", 1, 0.0, 3.35e9), ("k2", 2, 6.7e10, 0.0)]}
    rec = {"work": work, "window": job_log([0.5, 0.5]),
           "trace": traced({"k0": 0.004, "k2": 0.016, "knn": 1e-3, "elementwise_other": 0.08,
                            "matmul": 0.3}, {"k0": 2, "k2": 4, "knn": 4})}
    r = lambda name: catalog.reader("layer_metrics", name)(rec)
    assert r("stage_ms.hybrid") == pytest.approx(1e3 * (0.08 + 0.3 + 1e-3) / 2)
    assert r("launches.hybrid") == 50.0
    # K0 1 ms, K2 1 ms least a launch; 2 jobs of 3 launches = 6 ms over 20 ms.
    assert r("window_roofline.hybrid") == pytest.approx(30.0)
    assert r("knn_roofline.dense") == pytest.approx(
        100.0 * 2 * peaks.least_seconds(0, work["knn_bytes"]) / 1e-3)
    assert r("matmul_ms.mesh") == pytest.approx(150.0)
    assert r("idle_share.dense") == pytest.approx(50.0)
    assert r("denoise_mfu") == pytest.approx(100.0 * 6.7e12 * 2 / 1.0 / peaks.FLOPS)
    rec["trace"]["counters"]["knn"] = 3  # the program made another number of searches
    assert r("knn_roofline.dense") is None
    rec["trace"]["counters"]["k2"] = 3
    assert r("window_roofline.hybrid") is None
    rec["trace"] = None
    for name in ("stage_ms.hybrid", "window_roofline.hybrid", "knn_roofline.mesh",
                 "graph_roofline.mesh", "idle_share.mesh", "launches.dense"):
        assert r(name) is None


def test_the_graph_roofline_needs_every_launch_the_work_lists():
    work = {"graph": [("feature_knn", 6.7e9, 0.0), ("edge_block", 0.0, 3.35e9),
                      ("edge_block", 0.0, 3.35e9)]}
    rec = {"work": work, "trace": traced({"feature_knn": 0.002, "edge_block": 0.008},
                                         {"feature_knn": 2, "edge_block": 4})}
    read = catalog.reader("layer_metrics", "graph_roofline.mesh")
    # 0.1 ms of operations and two edge blocks of 1 ms of bytes, 2 jobs.
    assert read(rec) == pytest.approx(100.0 * 2 * 0.0021 / 0.010)
    rec["trace"]["counters"]["edge_block"] = 2
    assert read(rec) is None
