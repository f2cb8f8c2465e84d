"""The result line, the check on loaded modules, and a run without a card."""

from __future__ import annotations

import json
import subprocess
import sys
import time

from benchmark import catalog, harness

from .conftest import ROOT


def test_the_line_has_its_keys_and_the_checks_last(checkout):
    cell = catalog.load_cell(checkout, "roof32k_dense", checkout / "benchmark")
    out = harness.run_cell(cell, 31, 0.3, False, "cpu", time.perf_counter())
    line = json.loads(json.dumps(out))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert set(line["metrics"]) == {"denoise_rate", "cloud_p95_ms", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["attempted"] >= 1 and line["failed"] == 0 and line["correct"] is True


def test_a_traced_run_reports_the_per_layer_metrics_it_can_read(checkout, monkeypatch):
    # On the CPU the profiler sees no device: stand in a slice.
    def fake_profile(run_jobs):
        run_jobs()
        return {"busy_s": 0.01, "window_s": 0.04, "groups": {"knn": 0.001, "matmul": 0.002},
                "kernels": 10, "breakdown": {"device_ops": [], "idle_gaps": []}}

    monkeypatch.setattr(harness.trace, "profile_jobs", fake_profile)
    cell = catalog.load_cell(checkout, "roof32k_dense", checkout / "benchmark")
    out = harness.run_cell(cell, 32, 0.2, True, "cpu", time.perf_counter())
    assert set(out["metrics"]) == {"launches.dense", "idle_share.dense", "denoise_mfu"}
    assert out["device"]["busy_s"] == 0.01 and out["device"]["window_s"] == 0.04
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_guard_compares_whole_top_level_names():
    import ngpd_tpu_torch  # noqa: F401

    assert harness.loaded_forbidden(["ngpd_tpu_torch", "ngpd_tpu_torch.core", "jaxtyping",
                                     "numpy", "flaxen"]) == []
    assert harness.loaded_forbidden(["ngpd_tpu.core.voting", "jax.numpy", "jaxlib", "flax",
                                     "torch"]) == ["flax", "jax.numpy", "jaxlib",
                                                   "ngpd_tpu.core.voting"]


def test_the_program_and_the_benchmark_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import ngpd_tpu_torch.core.cuda_fused, "
            "ngpd_tpu_torch.core.pipeline, ngpd_tpu_torch.meshproc.gcn_denoiser; "
            "from benchmark import catalog, harness, readings; "
            "[catalog.load_cell(catalog.HERE.parent, w) for w in "
            "('roof1m_hybrid', 'ico6_mesh', 'roof32k_dense')]; "
            "print(harness.loaded_forbidden())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "roof32k_dense",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_without_the_program_the_run_fails(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ico6_mesh",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
