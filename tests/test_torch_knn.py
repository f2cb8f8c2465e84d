"""kNN, neighbourhoods and the new metrics of the port against ngpd_tpu on
the same numpy-seeded inputs.

Tolerances. The reference's distance block is |a|^2 + |b|^2 - 2 a.b with
the product from XLA's dot, the port's with the three products written
out: the two round differently by an ulp of the largest term (a few 1e-7
on unit-scale clouds), so distances are held to 1e-6 and indices are
compared where the next distance is further than that away. On a cloud
of small integer coordinates every term is exact in float32, the two
sides compute identical distances with many exact ties, and the indices
must be equal everywhere: that pins the tie rule (the lower index wins,
``jax.lax.top_k``'s order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngpd_tpu.ops import metrics as jmetrics
from ngpd_tpu.ops import neighbors as jnb
from ngpd_tpu_torch.ops import knn as tknn
from ngpd_tpu_torch.ops import metrics as tmetrics
from ngpd_tpu_torch.ops import neighbors as tnb

from fixtures import cube_corner, random_cloud, sphere_cloud

jknn = importlib.import_module("ngpd_tpu.ops.knn")  # ngpd_tpu.ops.knn is the function

torch.set_num_threads(2)

D_TOL = 1e-6


def _integer_grid(side=7):
    g = np.arange(side, dtype=np.float32)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3)


def _same_neighbours(jn, jd, tn, td, exact=False):
    jd, td = np.asarray(jd), td.numpy()
    ji, ti = np.asarray(jn.idx), tn.idx.numpy()
    assert tn.idx.dtype == torch.int64 and tn.mask.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(jn.mask), tn.mask.numpy())
    finite = np.isfinite(jd)
    np.testing.assert_array_equal(finite, np.isfinite(td))
    np.testing.assert_allclose(td[finite], jd[finite], atol=D_TOL, rtol=0)
    if exact:
        np.testing.assert_array_equal(ti, ji)
        return
    # A slot is unambiguous when its distance is further than the
    # tolerance from both neighbours in the sorted row.
    gap = np.diff(np.where(finite, jd, 1e30), axis=1) > 4 * D_TOL
    clear = np.ones_like(finite)
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    clear &= finite
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(ti[clear], ji[clear])


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_matches_reference(exclude_self):
    pts = random_cloud(700, seed=1)
    jn, jd = jknn.knn(jnp.asarray(pts), 9, exclude_self=exclude_self,
                      point_tile=256, query_tile=128)
    tn, td = tknn.knn(torch.as_tensor(pts), 9, exclude_self=exclude_self,
                      point_tile=256, query_tile=128)
    _same_neighbours(jn, jd, tn, td)
    if exclude_self:
        assert not (tn.idx == torch.arange(700)[:, None]).any()
    else:
        assert torch.equal(tn.idx[:, 0], torch.arange(700))


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_exact_ties_take_the_lower_index(exclude_self):
    """Integer coordinates: identical distances on both sides, six
    neighbours at distance 1, twelve at 2; indices equal everywhere, with
    tiles that split the candidates so ties meet across the running set."""
    pts = _integer_grid()
    jn, jd = jknn.knn(jnp.asarray(pts), 10, exclude_self=exclude_self,
                      point_tile=64, query_tile=128)
    tn, td = tknn.knn(torch.as_tensor(pts), 10, exclude_self=exclude_self,
                      point_tile=64, query_tile=128)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _same_neighbours(jn, jd, tn, td, exact=True)
    assert (np.diff(td.numpy(), axis=1) == 0).mean() > 0.5  # the ties are there
    # The tile sizes do not change the result.
    tn2, td2 = tknn.knn(torch.as_tensor(pts), 10, exclude_self=exclude_self)
    assert torch.equal(tn2.idx, tn.idx) and torch.equal(td2, td)


def test_knn_cube_corner_cloud_with_near_ties():
    """The cube-corner fixture's grid spacing makes near-ties everywhere:
    distances to 1e-6, indices where unambiguous."""
    pts, _, _ = cube_corner(10, spacing=0.05)
    jn, jd = jknn.knn(jnp.asarray(pts), 8)
    tn, td = tknn.knn(torch.as_tensor(pts), 8)
    jd, tdn = np.asarray(jd), td.numpy()
    np.testing.assert_allclose(tdn, jd, atol=D_TOL, rtol=0)
    # Every returned index really lies at the returned distance.
    p = torch.as_tensor(pts)
    true = ((p[:, None, :] - p[tn.idx]) ** 2).sum(-1)
    np.testing.assert_allclose(true.numpy(), tdn, atol=D_TOL, rtol=0)


def test_knn_num_valid_and_queries():
    pts = random_cloud(500, seed=2)
    q = random_cloud(90, seed=3)
    jn, jd = jknn.knn(jnp.asarray(pts), 5, jnp.asarray(q), num_valid=jnp.asarray(420))
    tn, td = tknn.knn(torch.as_tensor(pts), 5, torch.as_tensor(q), num_valid=420)
    _same_neighbours(jn, jd, tn, td)
    assert int(tn.idx.max()) < 420
    # Fewer valid points than k: the missing slots are masked, index 0.
    jn, jd = jknn.knn(jnp.asarray(pts), 5, jnp.asarray(q), num_valid=jnp.asarray(3))
    tn, td = tknn.knn(torch.as_tensor(pts), 5, torch.as_tensor(q), num_valid=3)
    _same_neighbours(jn, jd, tn, td)
    assert not tn.mask[:, 3:].any() and torch.isinf(td[:, 3:]).all()
    with pytest.raises(ValueError, match="exclude_self"):
        tknn.knn(torch.as_tensor(pts), 5, torch.as_tensor(q), exclude_self=True)


def test_nn_distances_matches_reference():
    a, b = random_cloud(300, seed=4), random_cloud(800, seed=5)
    jd, ji = jknn.nn_distances(jnp.asarray(a), jnp.asarray(b), num_valid_b=jnp.asarray(700))
    td, ti = tknn.nn_distances(torch.as_tensor(a), torch.as_tensor(b), num_valid_b=700,
                               query_tile=128, point_tile=256)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=D_TOL, rtol=0)
    assert np.mean(ti.numpy() == np.asarray(ji)) > 0.99


def test_pairwise_sqdist_matches_reference():
    a, b = random_cloud(64, seed=6), random_cloud(50, seed=7)
    want = np.asarray(jknn.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    got = tknn.pairwise_sqdist(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    assert (got >= 0).all()


@pytest.mark.parametrize("table_bits", [None, 6])
def test_cell_hash_matches_reference_with_wraparound(table_bits):
    """Cells large enough that the int32 products wrap in the reference;
    the int64 products keep the same low bits. Negative cells too."""
    rng = np.random.default_rng(8)
    cells = rng.integers(-50, 4000, size=(2000, 3)).astype(np.int32)
    bits = 14 if table_bits is None else table_bits
    want = np.asarray(jknn._cell_hash(jnp.asarray(cells), bits))
    got = tknn._cell_hash(torch.as_tensor(cells), bits).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.abs(cells.astype(np.int64) * 83492791) > 2**31).any()


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_grid_matches_reference(exclude_self):
    pts, _ = sphere_cloud(1500, seed=9)
    cell_j = jknn.estimate_cell_size(jnp.asarray(pts), 8)
    cell_t = tknn.estimate_cell_size(torch.as_tensor(pts), 8)
    np.testing.assert_allclose(float(cell_t), float(cell_j), rtol=1e-5)
    jn, jd = jknn.knn_grid(jnp.asarray(pts), 8, cell_j, exclude_self=exclude_self,
                           num_valid=jnp.asarray(1400), query_tile=512)
    tn, td = tknn.knn_grid(torch.as_tensor(pts), 8, float(cell_j), exclude_self=exclude_self,
                           num_valid=1400, query_tile=512)
    _same_neighbours(jn, jd, tn, td)
    # ... and agrees with the brute-force search on the valid rows.
    bn, bd = tknn.knn(torch.as_tensor(pts), 8, exclude_self=exclude_self, num_valid=1400)
    np.testing.assert_allclose(td[:1400].numpy(), bd[:1400].numpy(), atol=D_TOL, rtol=0)


def test_knn_grid_exact_ties_and_small_table():
    """Integer grid through the voxel hash with a table small enough that
    cells collide (colliding runs only add candidates)."""
    pts = _integer_grid(6)
    jn, jd = jknn.knn_grid(jnp.asarray(pts), 7, 1.5, table_bits=7, capacity=32)
    tn, td = tknn.knn_grid(torch.as_tensor(pts), 7, 1.5, table_bits=7, capacity=32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tn.idx.numpy(), np.asarray(jn.idx))


def _shared_nbh(n=200, k=6, seed=10):
    pts = random_cloud(n, seed=seed)
    jn, _ = jknn.knn(jnp.asarray(pts), k)
    mask = np.asarray(jn.mask).copy()
    mask[::7, -2:] = False  # some invalid slots
    jn = jnb.Neighborhood(jn.idx, jnp.asarray(mask))
    return pts, jn, tnb.Neighborhood.from_numpy(np.asarray(jn.idx), mask)


def test_neighborhood_reductions_match_reference():
    pts, jn, tn = _shared_nbh()
    assert tn.num_queries == 200 and tn.k == 6 and tn.idx.dtype == torch.int64
    rng = np.random.default_rng(11)
    vals = rng.normal(size=(200, 3)).astype(np.float32)
    w = rng.uniform(size=(200, 6)).astype(np.float32)
    jv, tv = jn.gather(jnp.asarray(vals)), tn.gather(torch.as_tensor(vals))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for name in ("sum", "mean", "max"):
        np.testing.assert_allclose(getattr(tn, name)(tv).numpy(),
                                   np.asarray(getattr(jn, name)(jv)), atol=1e-6)
    np.testing.assert_array_equal(tn.degree().numpy(), np.asarray(jn.degree()))
    np.testing.assert_allclose(tn.weighted_sum(torch.as_tensor(w), tv).numpy(),
                               np.asarray(jn.weighted_sum(jnp.asarray(w), jv)), atol=1e-6)
    extra = rng.uniform(size=(200, 6)) > 0.5
    np.testing.assert_array_equal(tn.and_mask(torch.as_tensor(extra)).mask.numpy(),
                                  np.asarray(jn.and_mask(jnp.asarray(extra)).mask))
    rows = np.array([3, 5, 8])
    np.testing.assert_array_equal(tn.filter_rows(torch.as_tensor(rows)).idx.numpy(),
                                  np.asarray(jn.filter_rows(jnp.asarray(rows)).idx))


def test_small_tensor_helpers_match_reference():
    rng = np.random.default_rng(12)
    a = rng.normal(size=(40, 3)).astype(np.float32)
    b = rng.normal(size=(40, 3)).astype(np.float32)
    m = rng.normal(size=(40, 3, 3)).astype(np.float32)
    a[0] = 0.0
    np.testing.assert_array_equal(tnb.outer3(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                                  np.asarray(jnb.outer3(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_allclose(tnb.matvec3(torch.as_tensor(m), torch.as_tensor(a)).numpy(),
                               np.asarray(jnb.matvec3(jnp.asarray(m), jnp.asarray(a))),
                               atol=1e-6)
    np.testing.assert_allclose(tnb.normalize(torch.as_tensor(a)).numpy(),
                               np.asarray(jnb.normalize(jnp.asarray(a))), atol=1e-6)


def test_neighborhood_triangles_match_reference():
    _, jn, tn = _shared_nbh(n=60, k=5)
    jt, jv = jnb.neighborhood_triangles(jn)
    tt, tv = tnb.neighborhood_triangles(tn)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tv.sum()) > 0


def test_new_metrics_match_reference():
    pts, jn, tn = _shared_nbh()
    p_j, p_t = jnp.asarray(pts), torch.as_tensor(pts)
    np.testing.assert_allclose(float(tmetrics.average_edge_length(p_t, tn)),
                               float(jmetrics.average_edge_length(p_j, jn)), rtol=1e-6)
    np.testing.assert_allclose(float(tmetrics.pointcloud_radius(p_t)),
                               float(jmetrics.pointcloud_radius(p_j)), rtol=1e-6)
    rng = np.random.default_rng(13)
    a = rng.normal(size=(200, 3)).astype(np.float32)
    b = a + 0.3 * rng.normal(size=(200, 3)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    w = rng.uniform(size=200).astype(np.float32)
    for args_j, args_t in (((jnp.asarray(a), jnp.asarray(b)),
                            (torch.as_tensor(a), torch.as_tensor(b))),
                           ((jnp.asarray(a), jnp.asarray(b), jnp.asarray(w)),
                            (torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(w)))):
        np.testing.assert_allclose(float(tmetrics.mean_angular_error(*args_t)),
                                   float(jmetrics.mean_angular_error(*args_j)), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics.msae(torch.as_tensor(a), torch.as_tensor(b))),
                               float(jmetrics.msae(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
