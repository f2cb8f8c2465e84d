"""``correct`` comes out true for the sound program and false for the
lower-precision control and for a broken timed path: a job that returns
its input unchanged, half of the points left out, an answer altered where
it is produced. The runs skip the look for a card and run on the CPU at
small sizes with the cells' own limits."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import catalog, harness


def unchanged(run):
    def f(job):
        out = run(job)
        return (job.get("points", job.get("vertices")).clone(),) + tuple(out[1:])
    return f


def half(run):
    def f(job):
        out = run(job)
        src = job.get("points", job.get("vertices"))
        keep = torch.arange(src.shape[0]) < src.shape[0] // 2
        return (torch.where(keep[:, None], out[0], src),) + tuple(out[1:])
    return f


def altered(run):
    def f(job):
        out = run(job)
        return (torch.roll(out[0], 1, dims=0),) + tuple(out[1:])
    return f


CELLS = ("roof32k_dense", "roof1m_hybrid", "ico6_mesh")


def run(checkout, cell_name, faults=None, seed=41):
    cell = catalog.load_cell(checkout, cell_name, checkout / "benchmark")
    return harness.run_cell(cell, seed, 0.1, False, "cpu", time.perf_counter(), faults)


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_is_correct(checkout, cell):
    out = run(checkout, cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [unchanged, half, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(checkout, cell, fault):
    out = run(checkout, cell, fault)
    assert not out["correct"], out["checks"]


# At the test's size the hybrid's plain versions equal its reference bit
# for bit and the control reads 2.8e-6 at the median (8,192 points, 20
# iterations); the cell's limits were set from the kernels' gap at 1M
# points and 20 iterations (PERF.md), above that. So the hybrid's control
# is held to a limit for this size.
CONTROL_SIZE = {"roof1m_hybrid": ({"iterations": 20}, {"pos_median": 5e-7, "far_share": 1e-3})}


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(checkout, cell):
    traffic, limits = CONTROL_SIZE.get(cell, ({}, None))
    c = catalog.load_cell(checkout, cell, checkout / "benchmark")
    c.traffic.update(traffic)
    if limits:
        c = c._replace(limits=limits)
        assert harness.run_cell(c, 41, 0.1, False, "cpu", time.perf_counter())["correct"]

    def control(run_):
        def f(job):
            run_(job)  # the program's work, then the control's answer in its place
            return c.entry.reference(c.config, c.traffic, job, control=True)
        return f

    out = harness.run_cell(c, 41, 0.1, False, "cpu", time.perf_counter(), control)
    assert not out["correct"], out["checks"]
