"""Fixtures of the benchmark's tests: a scratch benchmark directory built
from the real one, and the card, where there is one."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Small mixes of the three cells' shapes for the CPU.
SMALL_TRAFFIC = {
    "roof1m_x20": {"shape": "roof_cloud", "points": 8192, "noise": 0.02, "pool": 2,
                   "iterations": 2, "sample": 2, "trace_jobs": 1},
    "roof32k_x2": {"shape": "roof_cloud", "points": 2048, "noise": 0.02, "pool": 3,
                   "iterations": 2, "sample": 3, "trace_jobs": 2},
    "ico6_2pass": {"shape": "icosphere_mesh", "subdiv": 1, "radius": 0.6, "noise": 0.3,
                   "pool": 2, "sample": 1, "trace_jobs": 1},
}


def make_checkout(tmp: Path, traffic=SMALL_TRAFFIC) -> Path:
    """A checkout root under ``tmp`` whose ``benchmark/`` holds the real
    entries, readers, configurations and limits, and ``traffic`` as its
    mixes; the hybrid route taken from 4,000 points, so that a small cloud
    reaches it."""
    bd = tmp / "benchmark"
    for d in ("entries", "end_to_end", "layer_metrics", "configs", "limits"):
        shutil.copytree(BENCH / d, bd / d)
    (bd / "traffic").mkdir()
    for name, mix in traffic.items():
        (bd / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    cfg = json.loads((BENCH / "configs" / "nvt_k32.json").read_text())
    cfg["hybrid_min_points"] = 4000
    (bd / "configs" / "nvt_k32.json").write_text(json.dumps(cfg))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    (tmp / "assets").symlink_to(ROOT / "assets")
    return tmp


@pytest.fixture
def checkout(tmp_path) -> Path:
    return make_checkout(tmp_path)


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
