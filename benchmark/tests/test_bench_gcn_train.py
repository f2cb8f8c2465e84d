"""The cell ``ico6_dgcnn_train`` (GCN-Denoiser's DGCNN training,
configuration ``gcn_denoiser_dgcnn_train``): its count worked out by hand,
its traffic, its files found by name, ``correct`` for the sound program
and not for the control or a stray parameter, and its six per-layer
readers on records made by hand."""

from __future__ import annotations

import json
import time

import pytest

from benchmark import catalog, harness
from benchmark import train_faults
from benchmark.counts import gcn, gcn_train, peaks
from benchmark.gen import pool
from benchmark.tests.conftest import ROOT, make_checkout
from benchmark.tests.test_bench_metrics import job_log, traced
from benchmark.tests.test_bench_spans import recorded_state

CELL = "ico6_dgcnn_train"
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "gcn_denoiser_dgcnn_train.json")
                    .read_text())
SMALL = {"ico6_train16": {"shape": "icosphere_mesh", "subdiv": 2, "radius": 0.6, "noise": 0.3,
                          "pool": 1, "steps": 3, "sample": 1, "trace_jobs": 1}}
METRICS = ("train_mfu", "backward_ms.train", "optimizer_host_ms.train", "matmul_ms.train",
           "launches.train", "idle_share.train")


def test_a_job_counts_sixteen_steps_of_256_patches_of_three_forwards():
    per_patch = gcn_train.flop_per_patch()
    # The folded forward (counts/gcn.py) three times, less conv1's input
    # gradient: its two (17, 64) maps on the 64 nodes.
    assert per_patch == 3 * 181_977_472 - 2 * 2 * 64 * 17 * 64 == 545_653_888
    w = gcn_train.job_work(CONFIG, {"steps": 16})
    assert w["flop"] == 16 * 256 * 545_653_888.0 and w["steps"] == 16
    # Each step's forward: the three feature-kNN convs search and all six
    # edge convs build their block, over one batch of 256 patches.
    assert [x[0] for x in w["graph"]].count("feature_knn") == 16 * 3
    assert [x[0] for x in w["graph"]].count("edge_block") == 16 * 6
    assert w["graph"][:9] == gcn.graph_launches(256, 256, 64, 8)


def test_the_traffic_is_one_noisy_icosphere_of_81920_faces():
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "ico6_train16.json").read_text())
    inputs = pool.make_pool(traffic, 2**31 + 9, "cpu")
    assert len(inputs) == 1 and inputs[0]["faces"].shape == (81_920, 3)
    assert traffic["steps"] * CONFIG["batch"] <= 81_920 - int(81_920 * CONFIG["val_fraction"])


def test_the_cell_is_found_by_name_with_its_six_metrics():
    cell = catalog.load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.config["entry"] == "gcn_dgcnn_train"
    assert cell.config["reduced"] == [] and cell.config["emb_dims"] == 1024
    assert {m["name"] for m in cell.end_to_end} == {"mesh_rate", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(METRICS) | {"graph_roofline.mesh"}
    assert set(cell.limits) == {"loss0_rel", "first_update_rel", "update_rel", "stats_rel"}


def _cell(co):
    cfg_path = co / "benchmark" / "configs" / "gcn_denoiser_dgcnn_train.json"
    cfg_path.write_text(json.dumps(dict(CONFIG, emb_dims=64, batch=8)))
    return catalog.load_cell(co, CELL, co / "benchmark")


def _run(tmp_path, faults=None, box=None):
    cell = _cell(make_checkout(tmp_path, SMALL))
    if box is not None:
        box["cell"] = cell
    return harness.run_cell(cell, 2**31 + 3, 0.1, False, "cpu", time.perf_counter(), faults)


def test_the_sound_program_is_correct(tmp_path):
    out = _run(tmp_path)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"mesh_rate", "setup_s"}


def test_a_stray_parameter_is_not_correct(tmp_path):
    def stray(run):
        def f(job):
            losses, params, stats, first = run(job)
            params = params.clone()
            params[: params.numel() // 2] += 1e-3  # half the parameters off by 10 lr
            return losses, params, stats, first
        return f

    out = _run(tmp_path, stray)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(train_faults.FAULTS))
def test_a_planted_fault_of_the_training_is_not_correct(tmp_path, fault):
    """The state left where it started, Adam at twice the learning rate,
    Adam without its bias correction."""
    out = _run(tmp_path, train_faults.FAULTS[fault])
    assert not out["correct"], out["checks"]
    # Each moves the parameters wholly otherwise, from the first step on.
    assert min(out["numbers"]["update_rel"], out["numbers"]["first_update_rel"]) > 0.9


def test_the_tf32_control_is_not_correct(tmp_path):
    box = {}

    def control(run):
        def f(job):
            run(job)
            c = box["cell"]
            return c.entry.reference(c.config, c.traffic, job, control=True)
        return f

    out = _run(tmp_path, control, box)
    assert not out["correct"], out["checks"]


def test_the_readers_divide_by_the_traced_jobs_and_check_the_step_counter(monkeypatch):
    work = gcn_train.job_work(CONFIG, {"steps": 16})
    spans = []
    for _ in range(2 * 16):
        spans += [("ngpd.train", None, 30.0, 30.0),
                  ("ngpd.train.optimizer", "ngpd.train", 4.0, 20.0),
                  ("ngpd.train.backward", "ngpd.train.optimizer", 12.0, 16.0)]
    recorded_state(monkeypatch, spans)
    rec = {"work": work, "window": job_log([0.5, 0.5]),
           "trace": traced({"matmul": 0.25}, {"train": 32}, kernels=37_000)}
    r = lambda name: catalog.reader("layer_metrics", name)(rec)
    assert r("backward_ms.train") == pytest.approx(16 * 16.0)
    assert r("optimizer_host_ms.train") == pytest.approx(16 * 4.0)
    assert r("matmul_ms.train") == pytest.approx(125.0)
    assert r("launches.train") == 18_500
    assert r("idle_share.train") == pytest.approx(50.0)
    assert r("train_mfu") == pytest.approx(100.0 * work["flop"] * 2 / 1.0 / peaks.FLOPS)
    rec["trace"]["counters"]["train"] = 31  # a step the counter did not count
    assert r("optimizer_host_ms.train") is None
    rec["trace"]["counters"]["train"] = 32
    rec["trace"]["jobs"] = 3  # spans that ran fewer times than the jobs say
    assert r("backward_ms.train") is None
    recorded_state(monkeypatch, spans[:1] * 32)  # a program without these spans
    rec["trace"]["jobs"] = 2
    assert r("backward_ms.train") is None and r("optimizer_host_ms.train") is None
    rec["trace"] = None
    for name in METRICS[1:]:
        assert r(name) is None


def test_the_graph_roofline_reads_the_training_job_where_every_replay_counted():
    work = gcn_train.job_work(CONFIG, {"steps": 16})
    rec = {"work": work, "trace": traced({"feature_knn": 0.004, "edge_block": 0.006},
                                         {"feature_knn": 2 * 48, "edge_block": 2 * 96})}
    read = catalog.reader("layer_metrics", "graph_roofline.mesh")
    least = sum(peaks.least_seconds(f, b) for _, f, b in work["graph"])
    assert read(rec) == pytest.approx(100.0 * 2 * least / 0.010)
    rec["trace"]["counters"]["feature_knn"] = 2 * 3  # the capture's counts alone
    assert read(rec) is None
