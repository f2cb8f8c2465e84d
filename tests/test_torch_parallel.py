"""The port's sharded geometry (``ngpd_tpu_torch/parallel/sharded.py``,
``fused_sharded.py`` and the core's sharded arguments) against the
reference's sharded functions, on the same seeded sphere clouds as
``tests/test_parallel.py`` and at its tolerances.

The reference runs in this process on the virtual CPU devices of
``tests/conftest.py`` (``make_mesh(3)`` takes the first three of eight).
The port runs in spawned gloo ranks, one group per world size for the
whole module (``tests/torch_dist_ranks.py::parallel_cases``); its rows come
back per rank and are joined in rank order. World size 3 pads every cloud
(2048 rows to 2049, then to 2304 for ranks x tile), so the padding and
``num_valid`` paths run.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ngpd_tpu.ops import metrics
from ngpd_tpu.parallel import (chamfer_distance_sharded, denoise_sharded, fused_denoise_sharded,
                               knn_sharded)
from ngpd_tpu.parallel.mesh import make_mesh, shard_points
from ngpd_tpu_torch.core import denoise as tsteps
from ngpd_tpu_torch.core import voting as tvoting
from ngpd_tpu_torch.core.fused import fused_denoise
from ngpd_tpu_torch.ops.neighbors import Neighborhood

from fixtures import sphere_cloud
from torch_dist_ranks import flip_bound, rows_of, run_ranks

torch.set_num_threads(2)
WORLDS = (8, 3)


def _noisy(n, seed, noise_seed):
    pts, nrm = sphere_cloud(n, seed=seed)
    rng = np.random.default_rng(noise_seed)
    return (pts + rng.normal(scale=0.03, size=pts.shape)).astype(np.float32), nrm


def _inputs(world):
    a, _ = sphere_cloud(300, seed=2)
    b, _ = sphere_cloud(260, seed=3)
    dn, dn_n = _noisy(256, 4, 5)
    fu, fu_n = _noisy(2048, 9, 10)
    # Chamfer counts padding rows as points: pad-free clouds, as the
    # reference's test takes.
    return {"knn": sphere_cloud(512, seed=0)[0], "knn_self": sphere_cloud(256, seed=1)[0],
            "cd_a": a[: 300 - 300 % world], "cd_b": b[: 260 - 260 % world],
            "dn_pts": dn, "dn_nrm": dn_n, "fu_pts": fu, "fu_nrm": fu_n}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return {w: run_ranks("parallel_cases", w, tmp_path_factory.mktemp(f"par{w}"), _inputs(w))
            for w in WORLDS}


@pytest.fixture(scope="module")
def ref():
    """The reference's sharded results per world size, computed once."""
    out = {}
    for w in WORLDS:
        inp, mesh = _inputs(w), make_mesh(w)
        r = {}
        sp, n = shard_points(jnp.asarray(inp["knn"]), mesh)
        r["knn"] = np.asarray(knn_sharded(sp, 8, mesh)[1])[:n]
        sp, n = shard_points(jnp.asarray(inp["knn_self"]), mesh)
        nbh, d = knn_sharded(sp, 6, mesh, exclude_self=True)
        r["knn_self"] = np.asarray(d)[:n]
        sa, _ = shard_points(jnp.asarray(inp["cd_a"]), mesh)
        sb, _ = shard_points(jnp.asarray(inp["cd_b"]), mesh)
        r["chamfer"] = float(chamfer_distance_sharded(sa, sb, mesh))
        sp, n = shard_points(jnp.asarray(inp["dn_pts"]), mesh)
        sn, _ = shard_points(jnp.asarray(inp["dn_nrm"]), mesh, pad_value=0.0)
        r["denoise"] = np.asarray(denoise_sharded(sp, sn, mesh, iterations=2)[0])[:n]
        sp, n = shard_points(jnp.asarray(inp["fu_pts"]), mesh)
        sn, _ = shard_points(jnp.asarray(inp["fu_nrm"]), mesh, pad_value=0.0)
        p, nn, c = fused_denoise_sharded(sp, sn, mesh, iterations=2, tile=128, window=128,
                                         num_valid=n)
        r["fused"] = (np.asarray(p)[:n], np.asarray(nn)[:n], np.asarray(c)[:n])
        out[w] = r
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_knn_sharded_matches_reference(port, ref, world):
    d, idx, mask = rows_of(port[world], "knn", 512)
    np.testing.assert_allclose(d, ref[world]["knn"], atol=1e-5)
    assert mask.all()


@pytest.mark.parametrize("world", WORLDS)
def test_knn_sharded_exclude_self(port, ref, world):
    d, idx, mask = rows_of(port[world], "knn_self", 256)
    np.testing.assert_allclose(d, ref[world]["knn_self"], atol=1e-5)
    assert not (idx == np.arange(256)[:, None]).any()


@pytest.mark.parametrize("world", WORLDS)
def test_chamfer_sharded_matches_reference(port, ref, world):
    got = [r["chamfer"] for r in port[world]]
    assert len(set(got)) == 1  # the same scalar on every rank
    np.testing.assert_allclose(got[0], ref[world]["chamfer"], rtol=1e-5)
    inp = _inputs(world)
    want = float(jnp.mean(metrics.chamfer_distance(jnp.asarray(inp["cd_a"]),
                                                   jnp.asarray(inp["cd_b"]))))
    np.testing.assert_allclose(got[0], want, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_denoise_sharded_matches_reference(port, ref, world):
    pos, _ = rows_of(port[world], "denoise", 256)
    np.testing.assert_allclose(pos, ref[world]["denoise"], atol=5e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_fused_denoise_sharded_matches_reference(port, ref, world):
    """Against the reference's sharded engine: classes above 99% and the
    positions within the flip bound of tests/test_torch_fused.py. The
    reference's jitted engine contracts ``aa + bb - 2ab`` into FMAs, which
    swaps a k-th neighbour on a few rows; its sharded and single-device
    engines contract alike and agree bit for bit, as the port's two do
    (the next test), so the difference here is the single-device one."""
    pos, nrm, cls = rows_of(port[world], "fused", 2048)
    flip_bound(pos, cls, *ref[world]["fused"][::2])


@pytest.mark.parametrize("world", WORLDS)
def test_fused_denoise_sharded_equals_the_single_device_engine(port, world):
    """The sharding layer's own contract at the reference test's bound
    (atol 2e-4, classes above 99%): the port's sharded engine against its
    ``fused_denoise`` on the same padded cloud (padding to ranks x tile
    moves the last windows' clip, so the single-device call gets the
    padded rows, declared invalid)."""
    inp = _inputs(world)
    n = len(inp["fu_pts"])
    padded = -(-n // (world * 128)) * world * 128
    rows = -(-n // world) * world  # shard_points' far rows, then zeros
    pts = np.zeros((padded, 3), np.float32)
    nrm = np.zeros((padded, 3), np.float32)
    pts[:n], nrm[:n] = inp["fu_pts"], inp["fu_nrm"]
    pts[n:rows] = 1e30
    want = fused_denoise(pts, nrm, iterations=2, tile=128, window=128, num_valid=n,
                         threshold_refresh=0, device="cpu")
    pos, nrm_got, cls = rows_of(port[world], "fused", n)
    np.testing.assert_allclose(pos, want[0][:n].numpy(), atol=2e-4)
    np.testing.assert_allclose(nrm_got, want[1][:n].numpy(), atol=2e-4)
    assert (cls == want[2][:n].numpy()).mean() > 0.99


@pytest.mark.parametrize("world", WORLDS)
def test_fused_denoise_sharded_gathers(port, world):
    """The replicated engine all-gathers its cloud and sends nothing
    point to point."""
    for r in port[world]:
        counts = r["fused_counts"]
        assert counts["all_gather"] >= 1 and counts["all_reduce"] >= 1
        assert counts["send"] == counts["recv"] == 0


def test_sharded_arguments_gather_from_the_whole_arrays():
    """The core's ``src_*`` arguments in one process: rows split in two
    halves, each gathering its neighbours from the whole arrays, give the
    rows of one call on the whole cloud, for every voting builder and
    every step. (``gather_fn`` and ``axis_name`` need a process group: the
    spawned ``denoise_sharded`` cases run them.)"""
    pts, nrm = _noisy(128, 7, 8)
    p, n = torch.as_tensor(pts), torch.as_tensor(nrm)
    rng = np.random.default_rng(1)
    nbh = Neighborhood.from_numpy(rng.integers(0, 128, (128, 8)), rng.random((128, 8)) > 0.2)
    mass = torch.as_tensor(rng.random(128).astype(np.float32))
    edge = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(128, 3))).float(), dim=1)
    d, delta = torch.tensor(0.05), torch.tensor(0.3)

    def rows(h):
        return Neighborhood(nbh.idx[h], nbh.mask[h])

    calls = {
        "pvt": lambda h: tvoting.pvt(p[h], rows(h), src_points=p),
        "nvt": lambda h: tvoting.nvt(rows(h), n[h], src_normals=n),
        "normal_filtered_nvt": lambda h: tvoting.normal_filtered_nvt(rows(h), n[h], 0.9, n),
        "better_filtered_nvt": lambda h: tvoting.better_filtered_nvt(p[h], rows(h), n[h], 0.9,
                                                                     p, n),
        "normal_filtered_pvt": lambda h: tvoting.normal_filtered_pvt(p[h], rows(h), n[h], 0.9,
                                                                     p, n),
        "better_filtered_pvt": lambda h: tvoting.better_filtered_pvt(p[h], rows(h), n[h], 0.9,
                                                                     p, n),
        "md_transformation": lambda h: _flat(tvoting.md_transformation(p[h], rows(h), n[h],
                                                                       mass, 3.0, p, n)),
        "corner_step": lambda h: (tsteps.corner_step(p[h], rows(h), n[h], d, 0.5, p, n),),
        "edge_step": lambda h: (tsteps.edge_step(p[h], rows(h), n[h], edge[h], d, 0.5, p, n),),
        "flat_step": lambda h: (tsteps.flat_step(p[h], rows(h), n[h], d, 0.5, delta, p, n),),
        "feature_step": lambda h: (tsteps.feature_step(p[h], rows(h), n[h], d, 0.5, p, n),),
        "new_step": lambda h: (tsteps.new_step(p[h], rows(h), n[h], d, 0.5, delta, p, n),),
    }
    for name, fn in calls.items():
        whole = fn(slice(None))
        assert all(isinstance(x, torch.Tensor) for x in whole), name
        halves = fn(slice(0, 64)), fn(slice(64, 128))
        for k in range(len(whole)):
            got = torch.cat([halves[0][k], halves[1][k]])
            np.testing.assert_allclose(got.numpy(), whole[k].numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def _flat(md):
    decomposition, scale = md
    return (*decomposition, scale)
