"""The dense (N, k) pipeline of the port against ngpd_tpu, module by
module and as a slice, on the same numpy-seeded inputs and the same
neighbourhoods (made once by the reference's kNN and handed to the port
through ``Neighborhood.from_numpy``).

Tolerances. Both sides run the same closed-form float32 math; the
reference is compiled by XLA (fused multiply-adds, einsum contractions in
its own order), the port rounds every operation on its own, so results
differ by a few ulps of the largest term: eigenvalues and tensors 2e-6,
unit vectors (eigenvectors up to sign, normals) 2e-5, positions 1e-5.
Integer outputs (classes, features) are equal. The float64 oracle
(tests/oracle.py) is held at the bounds the reference's own suite uses
for it (tests/test_denoise.py: steps 2e-3; one iteration > 95% classes
equal and 5e-3 on those).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngpd_tpu.config import DenoiseConfig as JaxConfig
from ngpd_tpu.core import denoise as jsteps
from ngpd_tpu.core import pipeline as jpipe
from ngpd_tpu.core import voting as jvoting
from ngpd_tpu.ops.knn import knn as jknn
from ngpd_tpu.ops.neighbors import Neighborhood as JaxNeighborhood
from ngpd_tpu_torch.config import DenoiseConfig
from ngpd_tpu_torch.core import denoise as tsteps
from ngpd_tpu_torch.core import pipeline as tpipe
from ngpd_tpu_torch.core import voting as tvoting
from ngpd_tpu_torch.ops import metrics as tmetrics
from ngpd_tpu_torch.ops.neighbors import Neighborhood

import oracle
from fixtures import cube_corner, sphere_cloud

torch.set_num_threads(2)

ANGLE = float(np.pi * 5 / 12)


def _cube(n=12, sigma=0.005, seed=0):
    pts, nrm, _ = cube_corner(n, spacing=0.05)
    rng = np.random.default_rng(seed)
    return (pts + rng.normal(scale=sigma, size=pts.shape)).astype(np.float32), nrm, pts


def _shared(k, n=12, drop=False):
    """(points, normals) as numpy, and one neighbourhood for both sides;
    ``drop`` invalidates some slots (and every slot of row 5)."""
    noisy, nrm, _ = _cube(n)
    jn, _ = jknn(jnp.asarray(noisy), k)
    mask = np.asarray(jn.mask).copy()
    if drop:
        mask[::5, -3:] = False
        mask[5] = False
    jn = JaxNeighborhood(jn.idx, jnp.asarray(mask))
    return noisy, nrm, jn, Neighborhood.from_numpy(np.asarray(jn.idx), mask)


def _same_decomposition(td, jd, n_close=2e-5):
    np.testing.assert_allclose(td.eigval.numpy(), np.asarray(jd.eigval), atol=2e-6)
    # Each eigenvector agrees up to sign where its eigenvalue is isolated
    # (a flat point's normal tensor has two zero eigenvalues, whose
    # eigenvectors are any basis of the plane).
    w = np.asarray(jd.eigval)
    thr = 0.05 * np.abs(w).max(axis=1)  # relative: position tensors are small
    gap01, gap12 = np.abs(w[:, 1] - w[:, 0]) > thr, np.abs(w[:, 2] - w[:, 1]) > thr
    isolated = np.stack([gap01, gap01 & gap12, gap12], axis=1)
    assert isolated[:, 2].mean() > 0.5
    dots = np.abs(np.sum(td.eigvec.numpy() * np.asarray(jd.eigvec), axis=1))  # per column
    assert (np.abs(dots[isolated] - 1.0) < n_close).all()


VOTING = [
    ("pvt", lambda v, p, nb, n: v.pvt(p, nb)),
    ("nvt", lambda v, p, nb, n: v.nvt(nb, n)),
    ("normal_filtered_nvt", lambda v, p, nb, n: v.normal_filtered_nvt(nb, n, 0.9)),
    ("better_filtered_nvt", lambda v, p, nb, n: v.better_filtered_nvt(p, nb, n, ANGLE)),
    ("normal_filtered_pvt", lambda v, p, nb, n: v.normal_filtered_pvt(p, nb, n, 0.9)),
    ("better_filtered_pvt", lambda v, p, nb, n: v.better_filtered_pvt(p, nb, n, ANGLE)),
]


@pytest.mark.parametrize("drop", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("name,fn", VOTING, ids=[v[0] for v in VOTING])
def test_voting_tensor_builders_match_reference(name, fn, drop):
    """Every builder, on full neighbourhoods and with invalid slots (one
    row has none, which takes each builder's rescue)."""
    noisy, nrm, jn, tn = _shared(12, drop=drop)
    jd = fn(jvoting, jnp.asarray(noisy), jn, jnp.asarray(nrm))
    td = fn(tvoting, torch.as_tensor(noisy), tn, torch.as_tensor(nrm))
    assert isinstance(td, tvoting.Decomposition)
    _same_decomposition(td, jd)


def test_decomposition_features_match_reference():
    noisy, nrm, jn, tn = _shared(12)
    jd = jvoting.better_filtered_nvt(jnp.asarray(noisy), jn, jnp.asarray(nrm), ANGLE)
    # The same decomposition on both sides, so integer outputs must be equal.
    td = tvoting.Decomposition(torch.as_tensor(np.asarray(jd.eigval)),
                               torch.as_tensor(np.asarray(jd.eigvec)))
    for got, want in zip(tvoting.nvt_features(td), jvoting.nvt_features(jd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    got_cls = tvoting.classes(td, 0.2)
    assert got_cls.dtype == torch.int32
    np.testing.assert_array_equal(got_cls.numpy(), np.asarray(jvoting.classes(jd, 0.2)))
    assert len(set(got_cls.tolist())) >= 2
    np.testing.assert_array_equal(tvoting.md_features(td).numpy(),
                                  np.asarray(jvoting.md_features(jd)))
    np.testing.assert_array_equal(tvoting.vu_features(td, 0.3).numpy(),
                                  np.asarray(jvoting.vu_features(jd, 0.3)))
    np.testing.assert_array_equal(
        tvoting.better_vu_features(td, torch.tensor(0.4), 6).numpy(),
        np.asarray(jvoting.better_vu_features(jd, jnp.asarray(0.4), 6)))
    n_t, n_j = torch.as_tensor(nrm), jnp.asarray(nrm)
    np.testing.assert_allclose(tvoting.vu_smoothed_normals(td, n_t, 0.3, 3.0).numpy(),
                               np.asarray(jvoting.vu_smoothed_normals(jd, n_j, 0.3, 3.0)),
                               atol=1e-6)
    assert tvoting.vu_filtered_normals is tvoting.vu_smoothed_normals
    np.testing.assert_allclose(tvoting.r_inv(td, n_t).numpy(),
                               np.asarray(jvoting.r_inv(jd, n_j)), atol=1e-6)
    a = np.asarray(nrm)
    np.testing.assert_allclose(
        tvoting._acos_dot(n_t, torch.as_tensor(a[::-1].copy())).numpy(),
        np.asarray(jvoting._acos_dot(n_j, jnp.asarray(a[::-1].copy()))), atol=1e-6)


def test_md_transformation_matches_reference():
    noisy, nrm, jn, tn = _shared(10, drop=True)
    mass = np.random.default_rng(1).uniform(0.5, 2.0, size=len(noisy)).astype(np.float32)
    jd, js = jvoting.md_transformation(jnp.asarray(noisy), jn, jnp.asarray(nrm),
                                       jnp.asarray(mass))
    td, ts = tvoting.md_transformation(torch.as_tensor(noisy), tn, torch.as_tensor(nrm),
                                       torch.as_tensor(mass))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    # The reflection axis normalises a double cross product that nearly
    # cancels for neighbours along the normal, so its rounding shows in
    # the tensor: 1e-4 on eigenvalues of order 1.
    np.testing.assert_allclose(td.eigval.numpy(), np.asarray(jd.eigval), atol=1e-4)


STEPS = ["flat", "edge", "corner", "feature", "new", "dummy"]


@pytest.mark.parametrize("drop", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("name", STEPS)
def test_steps_match_reference(name, drop):
    """Each of the six steps on shared neighbourhoods, with perturbed
    normals (so the corner system has full rank) and a threshold that lets
    15-96% of each step's moves through (so the clamp is exercised both
    ways), with and without a given delta."""
    noisy, nrm, jn, tn = _shared(8, drop=drop)
    rng = np.random.default_rng(2)
    y = rng.normal(size=noisy.shape)
    y = (y / np.linalg.norm(y, axis=1, keepdims=True)).astype(np.float32)
    nrm = nrm + 0.3 * rng.normal(size=nrm.shape)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    d, alpha = 0.01, 0.5
    pj, nj, pt, nt = jnp.asarray(noisy), jnp.asarray(nrm), torch.as_tensor(noisy), \
        torch.as_tensor(nrm)
    extra_j, extra_t = (), ()
    if name == "edge":
        extra_j, extra_t = (jnp.asarray(y),), (torch.as_tensor(y),)
    want = getattr(jsteps, f"{name}_step")(pj, jn, nj, *extra_j, jnp.asarray(d), alpha)
    got = getattr(tsteps, f"{name}_step")(pt, tn, nt, *extra_t, torch.tensor(d), alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    moved = np.abs(np.asarray(want) - noisy).max(axis=1) > 0
    if name != "dummy":
        assert 0.1 < moved.mean() < 0.98, moved.mean()
    if name in ("flat", "new"):
        want = getattr(jsteps, f"{name}_step")(pj, jn, nj, jnp.asarray(d), alpha,
                                               delta=jnp.asarray(0.3))
        got = getattr(tsteps, f"{name}_step")(pt, tn, nt, torch.tensor(d), alpha,
                                              delta=torch.tensor(0.3))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_clamp_step_and_three_term_system_match_reference():
    noisy, nrm, jn, tn = _shared(8)
    rng = np.random.default_rng(3)
    opt = (noisy + rng.normal(scale=0.01, size=noisy.shape)).astype(np.float32)
    for strict in (True, False):
        want = jsteps._clamp_step(jnp.asarray(noisy), jnp.asarray(opt), 0.5,
                                  jnp.asarray(0.006), strict)
        got = tsteps._clamp_step(torch.as_tensor(noisy), torch.as_tensor(opt), 0.5,
                                 torch.tensor(0.006), strict)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    w = rng.uniform(size=(len(noisy), 8)).astype(np.float32)
    ja, jb = jsteps._three_term_system(jnp.asarray(noisy), jn, jnp.asarray(nrm),
                                       jnp.asarray(w))
    ta, tb = tsteps._three_term_system(torch.as_tensor(noisy), tn, torch.as_tensor(nrm),
                                       torch.as_tensor(w))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5)


def test_feature_decompositions_and_class_delta_match_reference():
    noisy, nrm, jn, tn = _shared(12)
    pj, nj, pt, nt = jnp.asarray(noisy), jnp.asarray(nrm), torch.as_tensor(noisy), \
        torch.as_tensor(nrm)
    jd, jf = jpipe.my_feature_decomposition(pj, nj, jn, ANGLE)
    td, tf = tpipe.my_feature_decomposition(pt, nt, tn, ANGLE)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-5)
    _same_decomposition(td, jd, n_close=1e-4)
    jd, jf = jpipe.martin_feature_decomposition(pj, nj, jn, 0.9)
    td, tf = tpipe.martin_feature_decomposition(pt, nt, tn, 0.9)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-5)
    np.testing.assert_allclose(td.eigval.numpy(), np.asarray(jd.eigval), atol=2e-6)
    rows = np.arange(len(noisy)) % 3 == 0
    np.testing.assert_allclose(
        float(tpipe._class_delta(pt, tn, torch.as_tensor(rows))),
        float(jpipe._class_delta(pj, jn, jnp.asarray(rows))), rtol=1e-6)
    np.testing.assert_allclose(float(tpipe.step_threshold(pt)),
                               float(jpipe.step_threshold(pj)), rtol=1e-5)
    np.testing.assert_allclose(float(tpipe.step_threshold(pt, num_valid=300)),
                               float(jpipe.step_threshold(pj, num_valid=jnp.asarray(300))),
                               rtol=1e-5)
    assert tpipe.DEFAULT_STRATEGY == jpipe.DEFAULT_STRATEGY
    assert tpipe.STEP_NAMES == jpipe.STEP_NAMES


STRATEGIES = [("flat", "edge", "feature"), ("new", "corner", "feature"),
              ("dummy", "edge", "corner")]


@pytest.mark.parametrize("strategy", STRATEGIES, ids="-".join)
def test_denoise_iteration_matches_reference(strategy):
    noisy, nrm, jf, tf = _shared(16)
    _, _, js, ts = _shared(8)
    d, alphas = 0.01, (1.0, 0.2, 1.0)
    want = jpipe.denoise_iteration(jnp.asarray(noisy), jnp.asarray(nrm), jf, js,
                                   jnp.asarray(d), alphas, ANGLE, strategy=strategy)
    got = tpipe.denoise_iteration(torch.as_tensor(noisy), torch.as_tensor(nrm), tf, ts,
                                  torch.tensor(d), alphas, ANGLE, strategy=strategy)
    assert got[2].dtype == torch.int32
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert set(got[2].tolist()) == {0, 1, 2}
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    with pytest.raises(ValueError, match="unknown step"):
        tpipe.denoise_iteration(torch.as_tensor(noisy), torch.as_tensor(nrm), tf, ts,
                                torch.tensor(d), alphas, ANGLE,
                                strategy=("flat", "edge", "sharpen"))


@pytest.mark.parametrize("method", ["brute", "grid"])
def test_denoise_matches_reference(method):
    """The slice: two iterations, neighbours recomputed each, brute-force
    and voxel-hash. Classes equal, positions within 1e-5 (achieved 1e-9:
    the noisy cloud has no ties, so both sides pick the same neighbours)."""
    noisy, nrm, _ = _cube()
    cfg_j, cfg_t = JaxConfig(), DenoiseConfig()
    a, an, ac = jpipe.denoise(jnp.asarray(noisy), jnp.asarray(nrm), cfg_j, iterations=2,
                              neighbor_method=method)
    b, bn, bc = tpipe.denoise(noisy, nrm, cfg_t, iterations=2, neighbor_method=method,
                              device="cpu")
    np.testing.assert_array_equal(bc.numpy(), np.asarray(ac))
    diff = float(np.abs(b.numpy() - np.asarray(a)).max())
    print(f"achieved: max position difference {diff:.3g}")
    assert diff <= 1e-5
    np.testing.assert_allclose(bn.numpy(), np.asarray(an), atol=2e-5)
    assert float(np.abs(b.numpy() - noisy).max()) > 1e-4  # the points moved


def test_denoise_num_valid_matches_reference():
    noisy, nrm, _ = _cube()
    a, _, ac = jpipe.denoise(jnp.asarray(noisy), jnp.asarray(nrm), iterations=1,
                             num_valid=jnp.asarray(350))
    b, _, bc = tpipe.denoise(noisy, nrm, iterations=1, num_valid=350, device="cpu")
    np.testing.assert_array_equal(bc.numpy()[:350], np.asarray(ac)[:350])
    np.testing.assert_allclose(b.numpy()[:350], np.asarray(a)[:350], atol=1e-5)


def test_denoise_lowers_the_chamfer_distance():
    noisy, nrm, clean = _cube(sigma=0.01)
    out, _, _ = tpipe.denoise(noisy, nrm, iterations=3, device="cpu")
    cd = lambda p: float(tmetrics.chamfer_distance(torch.as_tensor(p),
                                                   torch.as_tensor(clean)).mean())
    assert cd(out.numpy()) < 0.8 * cd(noisy)


def test_denoise_rejects_bad_arguments():
    noisy, nrm, _ = _cube()
    with pytest.raises(ValueError, match="neighbor_method"):
        tpipe.denoise(noisy, nrm, neighbor_method="kdtree", device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        tpipe.denoise(noisy, nrm, iterations=0, device="cpu")


def test_dense_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the fallback cannot be observed")
    noisy, nrm, clean = _cube()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.denoise(noisy, nrm, iterations=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.denoise_until_minimum_error(noisy, nrm, clean, max_iterations=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.denoise_until_minimum_error_windowed(noisy, nrm, clean, max_iterations=1)


@pytest.mark.parametrize("max_iterations", [12, 2, 0])
def test_until_minimum_error_matches_reference(max_iterations):
    """The same stopping step, the previous iterate and its error: with
    room to find the minimum (the error rises after 8 of 12 iterations,
    so 7 are reported), cut by max_iterations, and with no iteration
    allowed (returns the input, err0 + 200, -1)."""
    noisy, nrm, clean = _cube()
    kw = dict(alphas=(1.0, 1.0, 1.0), d=0.05, max_iterations=max_iterations)
    want = jpipe.denoise_until_minimum_error(
        jnp.asarray(noisy), jnp.asarray(nrm), jnp.asarray(clean), **kw)
    got = tpipe.denoise_until_minimum_error(noisy, nrm, clean, device="cpu", **kw)
    assert got[3] == int(want[3])
    np.testing.assert_allclose(got[2], float(want[2]), rtol=1e-4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5)
    if max_iterations == 12:
        assert got[3] == 7


def test_until_minimum_error_windowed_matches_reference():
    """One hybrid iteration a step (use_pallas=True), against the
    reference's loop stepping with its hybrid engine in interpret mode; K0,
    K1 and K2 count once a step on a card and not at all on the CPU. The
    use_pallas=False and None routes (fused_denoise on the CPU) are held
    in tests/test_torch_fused.py."""
    from ngpd_tpu.core.pallas_fused import pallas_denoise_hybrid
    from ngpd_tpu.ops import metrics as jmetrics
    from ngpd_tpu_torch.kernels import window as kw

    noisy, nrm, clean = _cube()
    pos, nr = jnp.asarray(noisy), jnp.asarray(nrm)
    prev = (pos, nr, float(jnp.mean(jmetrics.paper_distance(jnp.asarray(clean), pos))))
    it = 0
    while it < 3:  # pipeline.py:400-412 with the Pallas step in interpret mode
        p2, n2, _ = pallas_denoise_hybrid(pos, nr, JaxConfig(), iterations=1, tile=128,
                                          window=128, interpret=True)
        err = float(jnp.mean(jmetrics.paper_distance(jnp.asarray(clean), p2)))
        if err >= prev[2]:
            break
        prev = (p2, n2, err)
        pos, nr = p2, n2
        it += 1
    kw.reset_launch_counts()
    got = tpipe.denoise_until_minimum_error_windowed(
        noisy, nrm, clean, max_iterations=3, tile=128, window=128, use_pallas=True,
        device="cpu")
    assert got[3] == it and it >= 1
    np.testing.assert_allclose(got[2], prev[2], rtol=1e-3)
    diff = np.abs(got[0].numpy() - np.asarray(prev[0])).max(axis=1)
    assert np.mean(diff <= 2e-3) >= 0.999 and diff.max() <= 2e-2
    assert kw.LAUNCHES == {"k0": 0, "k1": 0, "k2": 0}  # CPU tensors: plain versions


def test_steps_match_oracle():
    """flat, edge and feature steps against the ragged float64 oracle."""
    pts64, nrm64 = sphere_cloud(96, seed=7)
    pts64, nrm64 = pts64.astype(np.float64), nrm64.astype(np.float64)
    k, d_thr, alpha = 8, 100.0, 0.3
    idx = oracle.knn_with_self(pts64, k)
    rows = np.arange(len(pts64))
    tn = Neighborhood.from_numpy(idx, np.ones_like(idx, dtype=bool))
    p32 = torch.as_tensor(pts64.astype(np.float32))
    n32 = torch.as_tensor(nrm64.astype(np.float32))
    d = torch.tensor(d_thr)
    want = oracle.feature_step(pts64, idx, rows, nrm64, d_thr, alpha)
    np.testing.assert_allclose(tsteps.feature_step(p32, tn, n32, d, alpha).numpy(), want,
                               atol=2e-3)
    rng = np.random.default_rng(8)
    y = rng.normal(size=(len(pts64), 3))
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    want = oracle.edge_step(pts64, idx, rows, nrm64, y, d_thr, alpha)
    got = tsteps.edge_step(p32, tn, n32, torch.as_tensor(y.astype(np.float32)), d, alpha)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    want = oracle.flat_step(pts64, idx, rows, nrm64, d_thr, alpha)
    np.testing.assert_allclose(tsteps.flat_step(p32, tn, n32, d, alpha).numpy(), want,
                               atol=2e-3)


def test_denoise_iteration_matches_oracle():
    """One full iteration against the ragged oracle (class dispatch,
    per-class flat delta, VU smoothing), with the port's own kNN."""
    from ngpd_tpu_torch.ops.knn import knn

    pts, nrm = sphere_cloud(128, seed=9)
    k_feat, k_step, d_thr = 16, 8, 100.0
    alphas = (1.0, 0.2, 1.0)
    want_pos, _, want_cls = oracle.denoise_iteration(
        pts.astype(np.float64), nrm.astype(np.float64), k_feat, k_step, d_thr, alphas, ANGLE)
    p = torch.as_tensor(pts)
    got_pos, _, got_cls = tpipe.denoise_iteration(
        p, torch.as_tensor(nrm), knn(p, k_feat)[0], knn(p, k_step)[0],
        torch.tensor(d_thr), alphas, ANGLE)
    same = got_cls.numpy() == want_cls
    assert same.mean() > 0.95, same.mean()
    np.testing.assert_allclose(got_pos.numpy()[same], want_pos[same], atol=5e-3)
