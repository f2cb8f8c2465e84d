"""The seeded generators: one seed, one input; the sizes fixed by the mix."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.gen import pool, shapes

ROOF = {"shape": "roof_cloud", "points": 4100, "noise": 0.02, "pool": 3}
MESH = {"shape": "icosphere_mesh", "subdiv": 2, "radius": 0.6, "noise": 0.3, "pool": 2}


def test_the_same_seed_gives_the_same_inputs_and_another_seed_other_noise():
    big = 2**31 + 12345  # seeds may pass 32 signed bits
    a, b = pool.make_pool(ROOF, big, "cpu"), pool.make_pool(ROOF, big, "cpu")
    c = pool.make_pool(ROOF, big + 1, "cpu")
    assert len(a) == 3
    for x, y, z in zip(a, b, c):
        assert torch.equal(x["points"], y["points"]) and torch.equal(x["normals"], y["normals"])
        assert x["points"].shape == z["points"].shape == (4100, 3)
        assert not torch.equal(x["points"], z["points"])
    assert not torch.equal(a[0]["points"], a[1]["points"])  # the pool's inputs differ


def test_roof_noise_lies_along_the_normals_at_the_mix_level():
    job = pool.make_pool(dict(ROOF, points=250_000, pool=1), 7, "cpu")[0]
    off = job["points"] - job["clean"]
    along = torch.sum(off * job["normals"], dim=1)
    assert torch.allclose(off, along[:, None] * job["normals"], atol=1e-6)
    assert abs(float(along.std()) - 0.02) < 5e-4
    assert torch.allclose(torch.linalg.norm(job["normals"], dim=1), torch.ones(250_000), atol=1e-6)


def test_a_roof_of_a_square_size_is_the_grid_and_the_rest_repeats_grid_rows():
    pts, nrm = shapes.roof_grid(4100)
    assert pts.shape == (64 * 64, 3)
    job = pool.make_pool(ROOF, 3, "cpu")[0]
    assert torch.equal(job["clean"][: 64 * 64], torch.as_tensor(pts))
    extra = job["clean"][64 * 64:]
    assert bool((extra[:, None, :] == torch.as_tensor(pts)[None]).all(-1).any(-1).all())


def test_icosphere_matches_the_subdivision_counts_and_the_programs_mesh():
    from ngpd_tpu_torch.meshproc.synthetic import icosphere

    for s in (0, 1, 2, 3):
        v, f = shapes.icosphere(s, 0.6)
        assert f.shape == (20 * 4**s, 3) and v.shape == (10 * 4**s + 2, 3)
        m = icosphere(s, 0.6)
        assert np.array_equal(v, m.v.numpy()) and np.array_equal(f, m.f.numpy())


def test_mesh_noise_is_seeded_and_scaled_by_the_mean_edge_length():
    a = pool.make_pool(MESH, 99, "cpu")
    b = pool.make_pool(MESH, 99, "cpu")
    assert torch.equal(a[1]["vertices"], b[1]["vertices"])
    assert not torch.equal(a[0]["vertices"], a[1]["vertices"])
    v, f = a[0]["clean"], a[0]["faces"]
    off = torch.linalg.norm(a[0]["vertices"] - v, dim=1)
    ratio = float(off.pow(2).mean().sqrt() / shapes.mean_edge_length(v, f))
    assert 0.2 < ratio < 0.4
