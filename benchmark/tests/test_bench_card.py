"""On the card: a short run of each cell ends with a correct result line."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from .conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["roof32k_dense", "roof1m_hybrid", "ico6_mesh"])
def test_a_short_run_on_the_card_is_correct(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
