"""Normal estimation and orientation of the port against ngpd_tpu on the
same numpy-seeded clouds and the same neighbourhoods.

Tolerances: the PVT normal is an eigenvector of a float32 covariance the
two sides sum in different orders, so normals agree to 2e-5 up to sign
(the closed-form solver fixes no sign convention a rounding could not
flip on a flat patch; here none does). The wavefront orientation is a
chain of sign decisions on the same dots: the signs must be equal on
every point. The MST orientation is numpy code copied: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngpd_tpu.core import normals as jnormals
from ngpd_tpu.ops.knn import knn as jknn
from ngpd_tpu_torch.core import normals as tnormals
from ngpd_tpu_torch.ops.knn import knn as tknn
from ngpd_tpu_torch.ops.neighbors import Neighborhood

from fixtures import plane_grid, sphere_cloud

torch.set_num_threads(2)


def _sphere(n=600, seed=3, k=10):
    pts, true_n = sphere_cloud(n, seed=seed)
    jn, _ = jknn(jnp.asarray(pts), k, exclude_self=True)
    return pts, true_n, jn, Neighborhood.from_numpy(np.asarray(jn.idx), np.asarray(jn.mask))


def test_pvt_decomposition_and_normals_match_reference():
    pts, true_n, jn, tn = _sphere()
    jw, jv = jnormals.pvt_decomposition(jnp.asarray(pts), jn)
    tw, tv = tnormals.pvt_decomposition(torch.as_tensor(pts), tn)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=2e-6)
    want = np.asarray(jnormals.pvt_normals(jnp.asarray(pts), jn))
    got = tnormals.pvt_normals(torch.as_tensor(pts), tn).numpy()
    np.testing.assert_allclose(got, np.asarray(jv)[..., :, 0], atol=2e-5)
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert np.abs((got * true_n).sum(axis=1)).mean() > 0.98  # radial


def test_pvt_normals_on_plane():
    pts, _ = plane_grid(12)
    p = torch.as_tensor(pts)
    nbh, _ = tknn(p, 12, exclude_self=True)
    n = tnormals.pvt_normals(p, nbh).numpy()
    np.testing.assert_allclose(np.abs(n[:, 2]), 1.0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-4)


def test_tangent_basis_matches_reference():
    pts, _, jn, tn = _sphere()
    want = jnormals.tangent_basis(jnp.asarray(pts), jn)
    got = tnormals.tangent_basis(torch.as_tensor(pts), tn)
    # The tangents split two close eigenvalues (a sphere is isotropic in
    # its tangent plane), so they are less well conditioned than the normal.
    for g, w, tol in zip(got, want, (2e-5, 2e-4, 2e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)
    n, t1, t2 = (g.numpy() for g in got)
    np.testing.assert_allclose(np.sum(np.cross(n, t1) * t2, axis=1), 1.0, atol=1e-4)


@pytest.mark.parametrize("max_sweeps", [0, 3])
def test_orient_normals_signs_match_reference(max_sweeps):
    """The same (unoriented) normals and neighbourhood into both: every
    sign equal, with the loop run to its end and cut after 3 sweeps."""
    pts, true_n, jn, tn = _sphere()
    n = np.asarray(jnormals.pvt_normals(jnp.asarray(pts), jn))
    n = n * np.where(np.random.default_rng(5).uniform(size=(len(n), 1)) < 0.5, -1, 1)
    n = n.astype(np.float32)
    want = np.asarray(jnormals.orient_normals(jnp.asarray(pts), jnp.asarray(n), jn,
                                              max_sweeps=max_sweeps))
    got = tnormals.orient_normals(torch.as_tensor(pts), torch.as_tensor(n), tn,
                                  max_sweeps=max_sweeps).numpy()
    np.testing.assert_array_equal(got, want)
    outward = ((got * true_n).sum(axis=1) > 0).mean()
    if max_sweeps == 0:
        assert outward > 0.99, outward
    else:
        assert outward < 0.99  # the wavefront had not arrived everywhere


def test_orient_normals_mst_matches_reference_and_wavefront():
    pts, _, jn, tn = _sphere(400, seed=4)
    n = np.asarray(jnormals.pvt_normals(jnp.asarray(pts), jn))
    idx = np.asarray(jn.idx)
    want = jnormals.orient_normals_mst(pts, n, idx)
    got = tnormals.orient_normals_mst(pts, n, idx)
    np.testing.assert_array_equal(got, want)
    assert tnormals.FLIP_THRESHOLD == jnormals.FLIP_THRESHOLD
    wave = tnormals.orient_normals(torch.as_tensor(pts), torch.as_tensor(n), tn).numpy()
    assert ((wave * got).sum(axis=1) > 0).mean() > 0.98


def test_estimated_normals_of_the_cli_match_reference():
    """The CLI's route for clouds without normals: kNN(12, exclude_self)
    -> PVT normals -> wavefront orientation, end to end on both sides with
    each side's own kNN."""
    from ngpd_tpu.apps.cli import _estimated_normals as j_est
    from ngpd_tpu_torch.apps.cli import _estimated_normals as t_est

    pts, true_n = sphere_cloud(500, seed=6)
    want = np.asarray(j_est(jnp.asarray(pts)))
    got = t_est(torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert ((got * true_n).sum(axis=1) > 0).mean() > 0.99
