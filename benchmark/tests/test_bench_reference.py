"""Each plain reference against the port, at a tiny size on the CPU, and
the references' independence from the program."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import torch

from benchmark.gen import pool
from benchmark.reference import numerics

from .conftest import BENCH, ROOT

NVT = json.loads((BENCH / "configs" / "nvt_k32.json").read_text())
GCN = dict(json.loads((BENCH / "configs" / "gcn_denoiser_dgcnn.json").read_text()),
           root=str(ROOT))


def _entry(name):
    from benchmark.catalog import load_module

    return load_module(BENCH / "entries" / f"{name}.py", f"test_entry_{name}")


def test_no_reference_imports_the_program_or_jax():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tree = ast.parse(Path(path).read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("ngpd_tpu", "ngpd_tpu_torch", "jax", "jaxlib",
                                               "flax"), (path, n)


def test_tf32_rounding_keeps_ten_mantissa_bits_nearest_even():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, -3.0,
                      float("inf")])
    want = torch.tensor([1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0, -3.0, float("inf")])
    assert torch.equal(numerics.round_tf32(x), want)


def _cloud(n, seed):
    return pool.make_pool({"shape": "roof_cloud", "points": n, "noise": 0.02, "pool": 1},
                          seed, "cpu")[0]


def test_the_dense_reference_is_the_ports_dense_pipeline():
    entry = _entry("nvt_denoise")
    traffic = {"points": 3000, "iterations": 2}
    job = _cloud(3000, 11)
    out = entry.System(NVT, traffic, torch.device("cpu")).run(job)
    ref = entry.reference(NVT, traffic, job)
    nums = entry.compare(out, ref)
    # The sums' order differs (written out against contractions), so a point
    # near a threshold may take another class: rare, and far apart.
    assert nums["pos_median"] < 1e-7 and nums["far_share"] < 2e-3
    moved = (out[0] - job["points"]).abs().amax(dim=1).median()
    assert moved > 1e-3  # the denoise did move the points


def test_the_hybrid_reference_is_the_ports_hybrid_engine():
    entry = _entry("nvt_denoise")
    cfg = dict(NVT, hybrid_min_points=4000)
    traffic = {"points": 8192, "iterations": 3}
    job = _cloud(8192, 12)
    sys_ = entry.System(cfg, traffic, torch.device("cpu"))
    assert sys_.route == "hybrid"
    nums = entry.compare(sys_.run(job), entry.reference(cfg, traffic, job))
    assert nums["pos_max"] < 1e-6 and nums["class_share"] == 0.0


def test_the_mesh_reference_follows_the_ports_cascade():
    entry = _entry("gcn_mesh_cascade")
    traffic = {"shape": "icosphere_mesh", "subdiv": 2, "radius": 0.6, "noise": 0.3, "pool": 1}
    job = pool.make_pool(traffic, 13, "cpu")[0]
    out = entry.System(GCN, traffic, torch.device("cpu")).run(job)
    nums = entry.compare(out, entry.reference(GCN, traffic, job))
    control = entry.compare(entry.reference(GCN, traffic, job, control=True),
                            entry.reference(GCN, traffic, job))
    moved = float((out[0] - job["vertices"]).abs().amax(dim=1).median())
    assert nums["v_median"] < 0.01 * moved
    assert control["v_median"] > 5 * nums["v_median"]
