"""The whole slice: ngpd_tpu_torch's denoise_hybrid (device="cpu", the
plain window kernels) against ngpd_tpu's pallas_denoise_hybrid run with
interpret=True, on the same inputs made from a seed with numpy.

Target: classes equal and positions within 2e-3, the accuracy-ladder
bound of tests/test_pallas_fused.py:62-63. Where a threshold mask flips
(a distance or angle on the boundary, rounded differently by the two
frameworks), the mask-flip bound of test_pallas_fused.py:166-171 holds
instead: >= 99% of classes equal, >= 99.9% of points within 2e-3 and
all within 2e-2; the flip count is reported.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngpd_tpu.core.pallas_fused import pallas_denoise_hybrid
from ngpd_tpu_torch.core.cuda_fused import denoise_hybrid

from fixtures import cube_corner, sphere_cloud

torch.set_num_threads(2)

STRATEGIES = [("flat", "edge", "feature"), ("new", "corner", "feature"),
              ("dummy", "edge", "corner")]


def _cube():
    pts, nrm, _ = cube_corner(18, spacing=0.05)
    rng = np.random.default_rng(0)
    return (pts + rng.normal(scale=0.005, size=pts.shape)).astype(np.float32), nrm


def _sphere():
    pts, nrm = sphere_cloud(1024, seed=9)
    rng = np.random.default_rng(10)
    return (pts + rng.normal(scale=0.03, size=pts.shape)).astype(np.float32), nrm


def _compare(noisy, nrm, **kw):
    a, an, ac = pallas_denoise_hybrid(
        jnp.asarray(noisy), jnp.asarray(nrm), iterations=2, tile=128,
        window=128, interpret=True, **kw)
    b, bn, bc = denoise_hybrid(noisy, nrm, iterations=2, tile=128, window=128,
                               device="cpu", **kw)
    a, an, ac = np.asarray(a), np.asarray(an), np.asarray(ac)
    b, bn, bc = b.numpy(), bn.numpy(), bc.numpy()
    assert b.shape == a.shape and bc.dtype == np.int32
    assert np.isfinite(b).all() and np.isfinite(bn).all()
    # Normals are the VU filter's output, which switches projector where
    # an eigenvalue sits at tau: held to the mask-flip bound throughout.
    ndiff = np.abs(an - bn).max(axis=1)
    assert np.mean(ndiff <= 2e-3) >= 0.999 and ndiff.max() <= 2e-2
    diff = np.abs(a - b).max(axis=1)
    flips = int((ac != bc).sum())
    if flips == 0 and diff.max() <= 2e-3:
        return ac
    print(f"mask flips: {flips} classes, {int((diff > 2e-3).sum())} points > 2e-3")
    assert np.mean(ac == bc) >= 0.99
    assert np.mean(diff <= 2e-3) >= 0.999
    assert diff.max() <= 2e-2
    return ac


@pytest.mark.parametrize("sub", [1, 2])
@pytest.mark.parametrize("lagged", [False, True], ids=["fresh", "lagged"])
@pytest.mark.parametrize("strategy", STRATEGIES, ids="-".join)
def test_cube_corner_matches_reference(strategy, lagged, sub):
    """All three classes occur (867 face, 51 edge, 1 corner point in the
    reference), so every class branch of the update runs."""
    noisy, nrm = _cube()
    cls = _compare(noisy, nrm, strategy=strategy, lagged_nvt1=lagged, sub=sub)
    assert (np.bincount(cls, minlength=3) > 0).all()


@pytest.mark.parametrize("sub", [1, 2])
@pytest.mark.parametrize("lagged", [False, True], ids=["fresh", "lagged"])
def test_sphere_matches_reference(lagged, sub):
    noisy, nrm = _sphere()
    _compare(noisy, nrm, lagged_nvt1=lagged, sub=sub)


def test_cli_window_geometry_matches_reference():
    """The CLI's >= 100k route runs tile 256 with window 512 and
    feature_k 16; here at sphere size, where sub falls back to 1."""
    noisy, nrm = _sphere()
    a, _, ac = pallas_denoise_hybrid(
        jnp.asarray(noisy), jnp.asarray(nrm), iterations=2, window=512,
        interpret=True)
    b, _, bc = denoise_hybrid(noisy, nrm, iterations=2, window=512, device="cpu")
    assert np.array_equal(np.asarray(ac), bc.numpy())
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-3)


def test_padding_and_num_valid_match_reference():
    """A cloud that is not a multiple of the tile, with trailing rows
    declared padding through num_valid."""
    noisy, nrm = _cube()
    _compare(noisy[:900], nrm[:900], num_valid=850, sub=2)


def test_device_none_means_cuda():
    """The entry point never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the fallback cannot be observed")
    noisy, nrm = _cube()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        denoise_hybrid(noisy, nrm, iterations=1)
