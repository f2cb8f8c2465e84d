"""The cell ``roof102k_p2n_train`` (Patch2Normal's training, configuration
``patch2normal_md64_train``): its count worked out by hand, its traffic,
its files found by name, ``correct`` for the sound program and not for
the planted faults or the control, its seven per-layer readers on records
made by hand, and the reference importing nothing of the port or of JAX."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from benchmark import catalog, harness, train_faults
from benchmark.counts import p2n, p2n_train, peaks
from benchmark.gen import pool
from benchmark.tests.conftest import ROOT, make_checkout
from benchmark.tests.test_bench_metrics import job_log, traced
from benchmark.tests.test_bench_spans import recorded_state

CELL = "roof102k_p2n_train"
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "patch2normal_md64_train.json")
                    .read_text())
SMALL = {"roof102k_train64": {"shape": "roof_cloud", "points": 2500, "noise": 0.0, "pool": 1,
                              "steps": 3, "sample": 1, "trace_jobs": 1}}
METRICS = ("p2n_train_mfu", "launches.p2ntrain", "idle_share.p2ntrain", "backward_ms.p2ntrain",
           "optimizer_host_ms.p2ntrain", "batch_host_ms.p2ntrain", "edge_roofline.p2ntrain")


def test_a_job_counts_sixty_four_steps_of_64_patches_of_three_forwards():
    cfg = {"num_nodes": 4, "input_size": 8, "hidden": [2, 2, 4, 4, 4, 4, 6, 4, 2],
           "edgeconvs": 6, "prepool": 1, "output_size": 3, "patch_k": 3, "batch": 5}
    # Each EdgeConv folded: two (c_in, c_out) maps on the 4 nodes; the
    # prepool map on every node; the post-pool maps and the head.
    convs = 2 * 2 * 4 * (8 * 2 + 2 * 2 + 2 * 4 + 4 * 4 + 4 * 4 + 4 * 4)
    prepool = 2 * 4 * 20 * 6
    post = 2 * (12 * 4 + 4 * 2 + 2 * 3)
    assert p2n.flop_per_patch(cfg) == convs + prepool + post == 2_300
    # The weight and input gradients of every map, as many as its forward;
    # the first EdgeConv's input gradient (two 8 x 2 maps on 4 nodes) left out.
    assert p2n_train.flop_per_patch(cfg) == 3 * 2_300 - 2 * 2 * 4 * 8 * 2 == 6_644
    work = p2n_train.job_work(cfg, {"steps": 2})
    assert work["flop"] == 2 * 5 * 6_644.0 and work["steps"] == 2
    # Six edge blocks a step over the batch, one an EdgeConv: the second
    # over 2-wide features, 5 patches of 4 nodes and 3 edges.
    assert [x[0] for x in work["graph"]] == ["edge_block"] * 12
    assert work["graph"][1] == ("edge_block", 5 * 4 * 3 * 2.0,
                                5 * 4 * 2 * 4.0 + 5 * 4 * 3 * 4.0 + 5 * 4 * 3 * 4 * 4.0)
    # At the configuration's widths: 112,886,144 a patch forward.
    assert p2n_train.flop_per_patch(CONFIG) == 3 * 112_886_144 - 2 * 2 * 64 * 8 * 64
    full = p2n_train.job_work(CONFIG, {"steps": 64})
    assert full["flop"] == 64 * 64 * 338_527_360.0 and len(full["graph"]) == 6 * 64


def test_the_traffic_is_the_clean_roof_of_102400_points():
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "roof102k_train64.json").read_text())
    inputs = pool.make_pool(traffic, 2**31 + 9, "cpu")
    assert len(inputs) == 1 and inputs[0]["points"].shape == (102_400, 3)
    assert bool((inputs[0]["points"] == inputs[0]["clean"]).all())  # noise 0: no repeated rows
    train = int(CONFIG["split"][0] * 102_400)
    assert traffic["steps"] * CONFIG["batch"] <= train


def test_the_cell_is_found_by_name_with_its_seven_metrics():
    cell = catalog.load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.config["entry"] == "p2n_train"
    assert cell.config["reduced"] == [] and cell.config["hidden"][0] == 64
    assert {m["name"] for m in cell.end_to_end} == {"denoise_rate", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    assert set(cell.limits) == {"loss0_rel", "first_update_rel", "update_rel", "stats_rel"}


def _cell(co):
    cfg_path = co / "benchmark" / "configs" / "patch2normal_md64_train.json"
    cfg_path.write_text(json.dumps(dict(CONFIG, batch=8)))
    return catalog.load_cell(co, CELL, co / "benchmark")


def _run(tmp_path, faults=None, box=None):
    cell = _cell(make_checkout(tmp_path, SMALL))
    if box is not None:
        box["cell"] = cell
    return harness.run_cell(cell, 2**31 + 3, 0.1, False, "cpu", time.perf_counter(), faults)


def test_the_sound_program_is_correct(tmp_path):
    out = _run(tmp_path)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"denoise_rate", "setup_s"}


@pytest.mark.parametrize("fault", sorted(train_faults.FAULTS))
def test_a_planted_fault_of_the_training_is_not_correct(tmp_path, fault):
    """The state left where it started, Adam at twice the learning rate,
    Adam without its bias correction."""
    out = _run(tmp_path, train_faults.FAULTS[fault])
    assert not out["correct"], out["checks"]
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


def test_the_readers_divide_by_the_traced_jobs_and_check_the_counters(monkeypatch):
    work = p2n_train.job_work(CONFIG, {"steps": 64})
    spans = []
    for _ in range(2 * 64):
        spans += [("ngpd.train.batch", None, 0.1, 0.05),
                  ("ngpd.train", None, 3.0, 3.0),
                  ("ngpd.train.optimizer", "ngpd.train", 1.5, 2.0),
                  ("ngpd.train.backward", "ngpd.train.optimizer", 0.5, 1.5)]
    recorded_state(monkeypatch, spans)
    rec = {"work": work, "window": job_log([0.5, 0.5]),
           "trace": traced({"edge_block": 0.002}, {"train": 128, "edge_block": 2 * 384},
                           kernels=20_000)}
    r = lambda name: catalog.reader("layer_metrics", name)(rec)
    assert r("backward_ms.p2ntrain") == pytest.approx(64 * 1.5)
    assert r("optimizer_host_ms.p2ntrain") == pytest.approx(64 * 1.5)
    assert r("batch_host_ms.p2ntrain") == pytest.approx(64 * 0.1)
    assert r("launches.p2ntrain") == 10_000
    assert r("idle_share.p2ntrain") == pytest.approx(50.0)
    assert r("p2n_train_mfu") == pytest.approx(100.0 * work["flop"] * 2 / 1.0 / peaks.FLOPS)
    least = sum(peaks.least_seconds(f, b) for _, f, b in work["graph"])
    assert r("edge_roofline.p2ntrain") == pytest.approx(100.0 * 2 * least / 0.002)
    rec["trace"]["counters"]["edge_block"] = 2 * 18  # the capture's warm-up alone
    assert r("edge_roofline.p2ntrain") is None
    rec["trace"]["counters"]["train"] = 127  # a step the counter did not count
    assert r("optimizer_host_ms.p2ntrain") is None
    rec["trace"]["jobs"] = 3  # spans that ran fewer times than the jobs say
    assert r("backward_ms.p2ntrain") is None and r("batch_host_ms.p2ntrain") is None
    recorded_state(monkeypatch, [s for s in spans if s[0] != "ngpd.train.batch"])
    rec["trace"]["jobs"] = 2  # a program without the batch span
    assert r("batch_host_ms.p2ntrain") is None and r("backward_ms.p2ntrain") is not None
    rec["trace"] = None
    for name in METRICS[1:]:
        assert r(name) is None


def test_the_reference_imports_nothing_of_the_port_or_of_jax():
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.gen import shapes\n"
        "from benchmark.reference import p2n_normals, p2n_train\n"
        "cfg = json.loads(sys.argv[1])\n"
        "clean = shapes.roof_cloud(400, 0.0, torch.Generator().manual_seed(0), 'cpu')[0]\n"
        "p2n_train.train(p2n_train.data_set(clean, cfg),\n"
        "                p2n_normals.draw_variables(cfg, 1), cfg, 2)\n"
        "banned = ('ngpd_tpu', 'ngpd_tpu_torch', 'jax', 'jaxlib', 'flax')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code, json.dumps(dict(CONFIG, batch=4))],
                         capture_output=True, text=True, check=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
