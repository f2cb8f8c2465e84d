"""Cells, configurations, mixes, limits and readers are found by name
from data files; a cell is added by new files and entries alone."""

from __future__ import annotations

import json
import time

import pytest

from benchmark import catalog, harness


def test_every_cell_of_the_benchmark_loads_with_its_files():
    bench = json.loads((catalog.HERE.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = catalog.load_cell(catalog.HERE.parent, w["name"])
        assert cell.limits and cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        for m in cell.end_to_end:
            catalog.reader("end_to_end", m["name"])
        for m in cell.per_layer:
            catalog.reader("layer_metrics", m["name"])
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_a_metric_without_workloads_goes_to_every_cell_that_reports_what_it_moves(checkout):
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "launches.any", "unit": "kernels", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "denoise_rate"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    bd = checkout / "benchmark"
    dense = catalog.load_cell(checkout, "roof32k_dense", bd)
    mesh = catalog.load_cell(checkout, "ico6_mesh", bd)
    assert "launches.any" in {m["name"] for m in dense.per_layer}
    assert "launches.any" not in {m["name"] for m in mesh.per_layer}


def test_a_new_cell_from_new_files_alone_runs(checkout):
    bd = checkout / "benchmark"
    (bd / "traffic" / "corner_small.json").write_text(json.dumps(
        {"shape": "corner_cloud", "points": 1500, "noise": 0.002, "pool": 2, "iterations": 2,
         "sample": 2, "trace_jobs": 1}))
    (bd / "limits" / "corner_dense.json").write_text(json.dumps(
        {"limits": {"pos_median": 1e-6, "far_share": 1e-3}}))
    (bd / "layer_metrics" / "jobs.corner.py").write_text(
        "def read(rec):\n    return float(len(rec['window']['jobs']))\n")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "corner_dense", "config": "nvt_k32",
                               "traffic": "corner_small", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "jobs.corner", "unit": "jobs", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "denoise_rate", "workloads": ["corner_dense"]})
    for m in bench["end_to_end"]:
        if m["name"] == "denoise_rate":
            m["workloads"].append("corner_dense")
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = catalog.load_cell(checkout, "corner_dense", bd)
    assert cell.traffic["shape"] == "corner_cloud" and cell.config["name"] == "nvt_k32"
    out = harness.run_cell(cell, 5, 0.5, False, "cpu", time.perf_counter())
    assert out["correct"] and set(out["metrics"]) == {"denoise_rate", "setup_s"}
    assert catalog.reader("layer_metrics", "jobs.corner", bd)(
        {"window": {"jobs": [1, 2]}}) == 2.0


def test_an_unknown_cell_or_a_missing_file_is_refused(checkout):
    with pytest.raises(KeyError):
        catalog.load_cell(checkout, "no_such_cell", checkout / "benchmark")
    (checkout / "benchmark" / "limits" / "roof32k_dense.json").unlink()
    with pytest.raises(FileNotFoundError):
        catalog.load_cell(checkout, "roof32k_dense", checkout / "benchmark")
