"""The port's halo engine (``ngpd_tpu_torch/parallel/halo.py``) against the
reference's, on the seeded noisy spheres of ``tests/test_halo.py``.

The reference runs in this process on the virtual CPU devices of
``tests/conftest.py``; the port in spawned gloo ranks, one group per world
size for the whole module (``tests/torch_dist_ranks.py::halo_cases``).
World size 3 pads the 2048-point cloud to 2049 rows and then to 2304,
and world size 1 sends nothing (the port alone, against its own
single-device functions). The reference's check that its compiled halo
program holds no all-gather becomes a count of the port's collective
calls.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ngpd_tpu.parallel.halo import fused_denoise_halo, morton_sort_sharded
from ngpd_tpu.parallel.mesh import make_mesh, shard_points
from ngpd_tpu_torch.core.fused import fused_denoise
from ngpd_tpu_torch.ops.morton import morton_sort

from fixtures import sphere_cloud
from torch_dist_ranks import flip_bound, rows_of, run_ranks

torch.set_num_threads(2)
WORLDS = (8, 3, 1)
REF_WORLDS = (8, 3)
N = 2048


def _noisy_sphere(n, seed):
    pts, nrm = sphere_cloud(n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    noisy = (pts + rng.normal(scale=0.03, size=pts.shape)).astype(np.float32)
    return noisy, nrm.astype(np.float32)


def _inputs():
    sort_pts, sort_nrm = _noisy_sphere(N, seed=3)
    pts, nrm = _noisy_sphere(N, seed=9)
    return {"sort_pts": sort_pts, "sort_nrm": sort_nrm, "pts": pts, "nrm": nrm}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return {w: run_ranks("halo_cases", w, tmp_path_factory.mktemp(f"halo{w}"), _inputs())
            for w in WORLDS}


@pytest.fixture(scope="module")
def ref():
    inp, out = _inputs(), {}
    for w in REF_WORLDS:
        mesh = make_mesh(w)
        sp, n = shard_points(jnp.asarray(inp["sort_pts"]), mesh)
        sn, _ = shard_points(jnp.asarray(inp["sort_nrm"]), mesh, pad_value=0.0)
        sc = morton_sort_sharded(sp, sn, mesh, num_valid=n)
        sp, n = shard_points(jnp.asarray(inp["pts"]), mesh)
        sn, _ = shard_points(jnp.asarray(inp["nrm"]), mesh, pad_value=0.0)
        halo = fused_denoise_halo(sp, sn, mesh, iterations=2, tile=128, window=128, num_valid=n)
        out[w] = {"sort": tuple(np.asarray(x)[:n] for x in (sc.pos, sc.nrm, sc.orig_idx)),
                  "halo": tuple(np.asarray(x)[:n] for x in halo)}
    return out


def _unsorted(rows):
    """Sorted-order outputs (..., orig_idx) back in original order."""
    *values, orig = rows
    inv = np.empty(len(orig), np.int64)
    inv[orig] = np.arange(len(orig))
    return tuple(v[inv] for v in values)


@pytest.mark.parametrize("world", WORLDS)
def test_morton_sort_sharded_matches_reference(port, ref, world):
    """Positions and normals exact, original indices equal: against the
    reference's distributed sort, and (world size 1) the port's own."""
    pos, nrm, orig = rows_of(port[world], "sort", N)
    if world in ref:
        want = ref[world]["sort"]
    else:
        inp = _inputs()
        sc = morton_sort(torch.as_tensor(inp["sort_pts"]), torch.as_tensor(inp["sort_nrm"]))
        want = (sc.pos.numpy(), sc.nrm.numpy(), sc.orig_idx.numpy())
    np.testing.assert_allclose(pos, want[0], atol=0)
    np.testing.assert_allclose(nrm, want[1], atol=0)
    np.testing.assert_array_equal(orig, want[2])


@pytest.mark.parametrize("world", REF_WORLDS)
def test_fused_denoise_halo_matches_reference(port, ref, world):
    """Against the reference's halo engine, both unsorted: classes above
    99% and the positions within the flip bound of tests/test_torch_fused.py.
    The reference's jitted window distances are FMA contractions, which
    swap a k-th neighbour on a few rows and move their smoothed normals
    (see tests/test_torch_parallel.py); the normals are held to the port's
    replicated engine below, as the reference's test holds its halo
    engine's, and the single-device engine's to the reference by
    tests/test_torch_fused.py."""
    pos, nrm, cls = _unsorted(rows_of(port[world], "halo", N))
    want_p, want_n, want_c = _unsorted(ref[world]["halo"])
    flip_bound(pos, cls, want_p, want_c)
    ndiff = np.abs(nrm - want_n).max(axis=1)
    print(f"normals: {np.mean(ndiff <= 2e-4):.4f} within 2e-4, max {ndiff.max():.3g}")


@pytest.mark.parametrize("world", WORLDS)
def test_fused_denoise_halo_equals_sharded(port, world):
    """Same windows, same math: the halo engine gives the replicated
    engine's rows after unsorting (atol 2e-4, classes above 99%), and on
    one rank the single-device engine's."""
    pos, nrm, cls = _unsorted(rows_of(port[world], "halo", N))
    want = rows_of(port[world], "sharded", N)
    np.testing.assert_allclose(pos, want[0], atol=2e-4)
    np.testing.assert_allclose(nrm, want[1], atol=2e-4)
    assert (cls == want[2]).mean() > 0.99
    if world == 1:
        inp = _inputs()
        single = fused_denoise(inp["pts"], inp["nrm"], iterations=2, tile=128, window=128,
                               threshold_refresh=0, device="cpu")
        np.testing.assert_allclose(pos, single[0].numpy(), atol=2e-4)
        assert (cls == single[2].numpy()).mean() > 0.99


@pytest.mark.parametrize("world", WORLDS)
def test_halo_engine_issues_no_all_gather(port, world):
    """The memory contract: no all-gather on any rank (the replicated
    engine issues several), the halos sent point to point, none on one
    rank."""
    for r in port[world]:
        assert r["halo_counts"]["all_gather"] == 0
        assert r["sharded_counts"]["all_gather"] >= 1
        sends, recvs = r["halo_counts"]["send"], r["halo_counts"]["recv"]
        assert sends == recvs and (sends > 0) == (world > 1)


@pytest.mark.parametrize("world", REF_WORLDS)
def test_halo_window_must_fit_a_shard(port, world):
    """A window wider than a rank's rows raises, in both packages."""
    inp = _inputs()
    mesh = make_mesh(world)
    sp, n = shard_points(jnp.asarray(inp["pts"]), mesh)
    sn, _ = shard_points(jnp.asarray(inp["nrm"]), mesh, pad_value=0.0)
    with pytest.raises(ValueError, match="must not exceed rows per shard") as err:
        fused_denoise_halo(sp, sn, mesh, iterations=2, tile=128, window=4096, num_valid=n)
    assert {r["wide_window"] for r in port[world]} == {str(err.value)}
