"""Per-point primitives of the port against ngpd_tpu: eigh3, the VU
filter, solve3 and Morton order, on inputs made from a seed with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngpd_tpu.ops import eigh3 as jeigh
from ngpd_tpu.ops import fastmath as jfastmath
from ngpd_tpu.ops import morton as jmorton
from ngpd_tpu.ops import neighbors as jneighbors
from ngpd_tpu.ops import solve3 as jsolve
from ngpd_tpu_torch.ops import eigh3, fastmath, morton, neighbors, solve3

torch.set_num_threads(2)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)).astype(np.float32)


def _degenerate(seed):
    """Repeated, zero and isotropic spectra, rotated at random."""
    rng = np.random.default_rng(seed)
    spectra = [(1, 1, 2), (0, 1, 1), (0, 0, 1), (0, 0, 0), (3, 3, 3), (0, 1, 2),
               (1e-4, 1, 1), (0, 0, 5)]
    mats = []
    for lam in spectra:
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        mats.append(q @ np.diag(lam) @ q.T)
    return np.asarray(mats, np.float32)


def _six(a):
    return [a[:, 0, 0], a[:, 0, 1], a[:, 0, 2], a[:, 1, 1], a[:, 1, 2], a[:, 2, 2]]


@pytest.mark.parametrize("kind", ["spd", "degenerate"])
def test_eigh3x3_matches_reference(kind):
    """Eigenvalues agree to float32 rounding of the trig formula: 1e-5 of
    the spectrum's scale for random SPD matrices, 1e-3 for repeated
    eigenvalues, where acos meets r = +-1 and an ulp of r moves the roots
    by ~sqrt(eps). Eigenvectors match up to sign where the eigenvalue is
    simple, and every port eigenpair satisfies A v = l v."""
    a = _spd(256, 1) if kind == "spd" else _degenerate(2)
    wj, vj = jeigh.eigh3x3(jnp.asarray(a))
    wt, vt = eigh3.eigh3x3(torch.as_tensor(a))
    wj, vj = np.asarray(wj), np.asarray(vj)
    scale = np.abs(a).max(axis=(1, 2))[:, None] + 1e-6
    tol = 1e-5 if kind == "spd" else 1e-3
    np.testing.assert_allclose(wt.numpy() / scale, wj / scale, atol=tol)
    resid = np.einsum("nij,njk->nik", a, vt.numpy()) - vt.numpy() * wt.numpy()[:, None, :]
    assert np.abs(resid).max() / scale.max() < 1e-4
    gap = np.minimum(np.diff(wj, axis=1, prepend=-np.inf)[:, :],
                     np.diff(wj, axis=1, append=np.inf)[:, :]) / scale
    simple = gap > 1e-2
    dots = np.abs(np.einsum("nij,nij->nj", vj, vt.numpy()))
    assert np.all(dots[simple] > 1 - 1e-4)


def test_acos_poly_matches_reference():
    """The same coefficients in the same Horner order, each operation
    rounded on its own on both sides, on 4097 points of [-1, 1] and beyond
    (where both clamp). torch's vectorised CPU sqrt is not correctly
    rounded (one ulp off on about 0.6% of inputs), so the two agree to two
    ulps of pi (2.4e-7), and both to the polynomial's 5e-7 of arccos."""
    x = np.concatenate([np.linspace(-1.0, 1.0, 4097, dtype=np.float32),
                        np.float32([-1.5, 1.5])])
    want = np.asarray(jfastmath.acos_poly(jnp.asarray(x)))
    got = fastmath.acos_poly(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=2.4e-7)
    np.testing.assert_allclose(got[:4097], np.arccos(x[:4097]), atol=5e-7)


@pytest.mark.parametrize("kind", ["spd", "degenerate"])
def test_eigh3x3_with_acos_poly_matches_reference(kind):
    """eigh3x3_components(acos_fn=acos_poly), the pass kernels' form,
    against the reference's with its acos_poly: the tolerances of
    test_eigh3x3_matches_reference, and eigenvectors up to sign where the
    eigenvalue is simple."""
    a = _spd(256, 11) if kind == "spd" else _degenerate(12)
    six = _six(a)
    wj, vj = jeigh.eigh3x3_components(*[jnp.asarray(x) for x in six],
                                      acos_fn=jfastmath.acos_poly)
    wt, vt = eigh3.eigh3x3_components(*[torch.as_tensor(x) for x in six],
                                      acos_fn=fastmath.acos_poly)
    wj = np.stack([np.asarray(x) for x in wj], axis=1)
    wt = torch.stack(wt, dim=1).numpy()
    scale = np.abs(a).max(axis=(1, 2))[:, None] + 1e-6
    tol = 1e-5 if kind == "spd" else 1e-3
    np.testing.assert_allclose(wt / scale, wj / scale, atol=tol)
    gap = np.minimum(np.diff(wj, axis=1, prepend=-np.inf),
                     np.diff(wj, axis=1, append=np.inf)) / scale
    for i in range(3):
        dots = np.abs(sum(np.asarray(vj[i][c]) * vt[i][c].numpy() for c in range(3)))
        assert np.all(dots[gap[:, i] > 1e-2] > 1 - 1e-4)


def test_eigvals_and_vu_filter_match_reference():
    """Projector-form VU filter, tau and damping as DenoiseConfig's
    defaults: eigenvalues and unit normals to 1e-3 (the repeated spectra
    carry the sqrt(eps) sensitivity of acos at r = +-1)."""
    rng = np.random.default_rng(3)
    a = np.concatenate([_spd(200, 4) / 10, _degenerate(5)])
    n = rng.normal(size=(len(a), 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    six = _six(a)
    wj = jeigh.eigvals3x3_components(*[jnp.asarray(x) for x in six])
    wt = eigh3.eigvals3x3_components(*[torch.as_tensor(x) for x in six])
    for x, y in zip(wj, wt):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-3)
    fj = jeigh.vu_filter_components([jnp.asarray(x) for x in six],
                                    [jnp.asarray(n[:, c]) for c in range(3)], 0.3, 3.0)
    ft = eigh3.vu_filter_components([torch.as_tensor(x) for x in six],
                                    [torch.as_tensor(n[:, c]) for c in range(3)], 0.3, 3.0)
    for x, y in zip(fj, ft):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-3)


def test_solve3x3_matches_reference_with_singular_rows():
    """Same guard decisions (rcond 1e-7) and, where solvable, solutions to
    1e-4 relative (adjugate over determinant in float32)."""
    rng = np.random.default_rng(6)
    a = _spd(128, 7)
    u = rng.normal(size=(len(a[::4]), 3)).astype(np.float32)
    a[::4] = u[:, :, None] * u[:, None, :]  # rank 1
    a[1::8, 2] = a[1::8, 0] + a[1::8, 1]  # rank 2
    a[2::16] = 0.0
    b = rng.normal(size=(len(a), 3)).astype(np.float32)
    fb = rng.normal(size=(len(a), 3)).astype(np.float32)
    xj, okj = jsolve.solve3x3_guarded(jnp.asarray(a), jnp.asarray(b), jnp.asarray(fb))
    xt, okt = solve3.solve3x3_guarded(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(fb))
    assert np.array_equal(okt.numpy(), np.asarray(okj))
    assert not okt.numpy().all() and okt.numpy().any()
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)
    rows = tuple(tuple(torch.as_tensor(a[:, i, j]) for j in range(3)) for i in range(3))
    xc, okc = solve3.solve3x3_components(
        rows, tuple(torch.as_tensor(b[:, c]) for c in range(3)),
        tuple(torch.as_tensor(fb[:, c]) for c in range(3)))
    rows_j = tuple(tuple(jnp.asarray(a[:, i, j]) for j in range(3)) for i in range(3))
    xcj, okcj = jsolve.solve3x3_components(
        rows_j, tuple(jnp.asarray(b[:, c]) for c in range(3)),
        tuple(jnp.asarray(fb[:, c]) for c in range(3)))
    assert np.array_equal(okc.numpy(), np.asarray(okcj))
    for x, y in zip(xcj, xc):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-4, atol=1e-4)


def test_det3_and_adjugate3_match_reference():
    """The public cofactor helpers: determinants and adjugates equal the
    reference's to float32 rounding, and A adj(A) = det(A) I."""
    a = np.concatenate([_spd(64, 8), _degenerate(9)])
    a[::5] *= -1.0  # negative determinants too
    dj, dt = jsolve.det3(jnp.asarray(a)), solve3.det3(torch.as_tensor(a))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)
    aj, at = jsolve.adjugate3(jnp.asarray(a)), solve3.adjugate3(torch.as_tensor(a))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6, atol=1e-6)
    eye = dt.numpy().astype(np.float64)[:, None, None] * np.eye(3)
    np.testing.assert_allclose(a.astype(np.float64) @ at.numpy(), eye, atol=1e-3)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_normalize_takes_the_reference_axis(axis):
    v = np.random.default_rng(10).normal(size=(7, 3)).astype(np.float32)
    v[2] = 0.0  # the eps clamp keeps a zero row at zero
    want = jneighbors.normalize(jnp.asarray(v), axis=axis)
    got = neighbors.normalize(torch.as_tensor(v), axis=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n,nv", [(1000, 1000), (1024, 919), (4096, 3000)])
def test_morton_matches_reference(n, nv):
    """Codes equal bit for bit; the sort order equals the reference's up
    to the order of rows inside one code (JAX's sort leaves ties
    unspecified, the port breaks them by original row)."""
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    dup = np.arange(0, n - 1, 7)
    pts[dup + 1] = pts[dup]  # duplicate cells
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    cj = np.asarray(jmorton.morton_codes(jnp.asarray(pts), nv))
    ct = morton.morton_codes(torch.as_tensor(pts), nv).numpy()
    assert np.array_equal(cj, ct)
    sj = jmorton.morton_sort(jnp.asarray(pts), jnp.asarray(nrm), nv)
    st = morton.morton_sort(torch.as_tensor(pts), torch.as_tensor(nrm), nv)
    oj, ot = np.asarray(sj.orig_idx), st.orig_idx.numpy()
    assert np.array_equal(ct[ot], cj[oj])
    for code in np.unique(ct):
        assert set(oj[cj[oj] == code]) == set(ot[ct[ot] == code])
    assert np.array_equal(np.sort(ot[ct[ot] == ct[ot][0]]), ot[ct[ot] == ct[ot][0]])
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(sj.pos)[np.argsort(oj)][ot])
    vals = torch.arange(n, dtype=torch.float32)[:, None]
    assert torch.equal(morton.unsort(vals[st.orig_idx], st.orig_idx), vals)
