"""The cell ``roof102k_normals`` (Patch2Normal's normals, configuration
``patch2normal_md64``): its counts worked out by hand, its traffic, its
files found by name, ``correct`` for the sound program and not for the
control or a far normal, and its seven per-layer readers on records made
by hand."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import catalog, harness
from benchmark.counts import graph, knn, p2n, peaks
from benchmark.gen import pool
from benchmark.tests.conftest import ROOT, make_checkout
from benchmark.tests.test_bench_metrics import job_log, traced
from benchmark.tests.test_bench_spans import recorded_state

CELL = "roof102k_normals"
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "patch2normal_md64.json").read_text())
SMALL = {"roof102k_p2n": {"shape": "roof_cloud", "points": 324, "noise": 0.02, "pool": 2,
                          "sample": 1, "trace_jobs": 1}}
METRICS = ("normals_mfu", "matmul_ms.p2n", "edge_roofline.p2n", "knn_roofline.p2n",
           "orient_host_ms.p2n", "pair_knn_ms.p2n", "idle_share.p2n")


def test_the_model_is_counted_in_its_folded_form():
    p = 64
    convs = 4 * p * (8 * 64 + 64 * 64 + 64 * 128 + 128 * 256 + 256 * 256 + 256 * 256)
    assert convs == 45_219_840
    prepool = 2 * p * 1024 * 512
    head = 2 * (1024 * 256 + 256 * 64 + 64 * 3)
    assert (prepool, head) == (67_108_864, 557_440)
    assert p2n.flop_per_patch(CONFIG) == convs + prepool + head == 112_886_144
    # The program's form, the linear maps on every one of the 12 edges, 5.4x.
    unfolded = 2 * p * 12 * 2 * (8 * 64 + 64 * 64 + 64 * 128 + 128 * 256 + 256 * 256
                                 + 256 * 256)
    assert unfolded + prepool + head == 610_304_384


def test_a_cloud_counts_three_searches_and_six_edge_blocks_a_batch():
    w = p2n.job_work(CONFIG, {"points": 102_400})
    assert w["flop"] == 102_400 * 112_886_144
    assert w["knn"] == [(102_400, 12), (102_400, 16), (102_400, 64)]
    assert w["knn_bytes"] == sum(knn.search_bytes(102_400, k) for k in (12, 16, 64))
    assert len(w["graph"]) == 600 and {x[0] for x in w["graph"]} == {"edge_block"}
    assert w["graph"][5] == ("edge_block",) + graph.edge_block(1024, 64, 256, 12)
    # A last, partial batch counts its own patches.
    tail = p2n.job_work(CONFIG, {"points": 1500})["graph"]
    assert len(tail) == 12 and tail[6] == ("edge_block",) + graph.edge_block(476, 64, 8, 12)


def test_the_traffic_draws_102400_distinct_rows():
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "roof102k_p2n.json").read_text())
    inputs = pool.make_pool(traffic, 2**31 + 7, "cpu")
    assert len(inputs) == 2
    for job in inputs:
        assert job["points"].shape == (102_400, 3)
        assert torch.unique(job["clean"], dim=0).shape[0] == 102_400
    assert not torch.equal(inputs[0]["points"], inputs[1]["points"])


def test_the_cell_is_found_by_name_with_its_seven_metrics():
    cell = catalog.load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.config["entry"] == "p2n_normals"
    assert cell.traffic["points"] == 102_400 and cell.config["reduced"] == []
    assert {m["name"] for m in cell.end_to_end} == {"cloud_p95_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    assert set(cell.limits) == {"median_ratio", "stable_p99", "stable_max"}
    for m in METRICS:
        catalog.reader("layer_metrics", m)


def _run(tmp_path, faults=None, cell=None):
    co = make_checkout(tmp_path, SMALL)
    c = cell(co) if cell else catalog.load_cell(co, CELL, co / "benchmark")
    return harness.run_cell(c, 2**31 + 3, 0.1, False, "cpu", time.perf_counter(), faults)


def test_the_sound_program_is_correct(tmp_path):
    out = _run(tmp_path)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"cloud_p95_ms", "setup_s"}


def test_a_far_normal_is_not_correct(tmp_path):
    def far(run):
        def f(job):
            n = run(job)[0].clone()
            n[7] = -n[7]  # one normal flipped
            return (n,)
        return f

    out = _run(tmp_path, far)
    assert not out["correct"], out["checks"]


def test_the_tf32_control_is_not_correct(tmp_path):
    box = {}

    def cell(co):
        box["c"] = catalog.load_cell(co, CELL, co / "benchmark")
        return box["c"]

    def control(run):
        def f(job):
            run(job)
            c = box["c"]
            return c.entry.reference(c.config, c.traffic, job, control=True)
        return f

    out = _run(tmp_path, control, cell)
    assert not out["correct"], out["checks"]


def _rec(work, groups, counters):
    return {"work": work, "window": job_log([2.0, 2.0]), "trace": traced(groups, counters)}


def test_the_readers_divide_by_the_traced_jobs_and_check_the_counters():
    work = p2n.job_work(CONFIG, {"points": 2048})
    least = sum(peaks.least_seconds(f, b) for _, f, b in work["graph"])
    rec = _rec(work, {"matmul": 0.4, "edge_block": 0.01, "knn": 0.02},
               {"edge_block": 24, "knn": 6})
    r = lambda name: catalog.reader("layer_metrics", name)(rec)
    assert r("matmul_ms.p2n") == pytest.approx(200.0)
    assert r("edge_roofline.p2n") == pytest.approx(100.0 * 2 * least / 0.01)
    assert r("knn_roofline.p2n") == pytest.approx(
        100.0 * 2 * peaks.least_seconds(0.0, work["knn_bytes"]) / 0.02)
    assert r("idle_share.p2n") == pytest.approx(50.0)
    assert r("normals_mfu") == pytest.approx(100.0 * work["flop"] * 2 / 4.0 / peaks.FLOPS)
    rec["trace"]["counters"]["edge_block"] = 23  # another number of launches
    rec["trace"]["counters"]["knn"] = 5
    assert r("edge_roofline.p2n") is None and r("knn_roofline.p2n") is None
    rec["trace"] = None
    for name in METRICS[1:]:
        assert r(name) is None


def test_the_span_readers_read_the_normals_spans(monkeypatch):
    spans = []
    for _ in range(2):
        spans += [("ngpd.normals", None, 2500.0, 2400.0),
                  ("ngpd.normals.orient", "ngpd.normals", 40.0, 35.0),
                  ("ngpd.normals.pair_knn", "ngpd.normals", 20.0, 90.0)]
    recorded_state(monkeypatch, spans)
    rec = {"trace": {"jobs": 2}}
    r = lambda name: catalog.reader("layer_metrics", name)(rec)
    assert r("orient_host_ms.p2n") == pytest.approx(40.0)
    assert r("pair_knn_ms.p2n") == pytest.approx(90.0)
    rec["trace"]["jobs"] = 3  # a span that ran fewer times than the jobs
    assert r("orient_host_ms.p2n") is None and r("pair_knn_ms.p2n") is None
    recorded_state(monkeypatch, spans[:1] * 2)  # a program without these spans
    rec["trace"]["jobs"] = 2
    assert r("orient_host_ms.p2n") is None and r("pair_knn_ms.p2n") is None
    assert catalog.reader("layer_metrics", "orient_host_ms.p2n")({"trace": None}) is None
