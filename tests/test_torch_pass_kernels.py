"""Pass kernels A-D and BD of the port against the JAX Pallas kernels.

The plain PyTorch versions (``ngpd_tpu_torch/kernels/passes.py``, what the
wrappers run on CPU tensors) are held against
``ngpd_tpu/core/pallas_fused.py``'s ``_make_pass_a/_b/_c/_d/_bd`` run
through ``pl.pallas_call(..., interpret=True)`` with ``pallas_denoise``'s
grid spec (l.915-1035, two prefetched scalars), on the same Morton-sorted cube-corner
packs (919 points padded to 1024, tile 128, window 128). Every pass but A
is fed the reference's output of the pass before, so each comparison sees
one pass alone. The CUDA kernels are held against these plain versions on
the card in test_torch_cuda.py.

Tolerances. Masks read distances computed in the reference's order on
both sides. Sums run in another order, and the reference's interpret-mode
kernels are compiled by XLA, which fuses a*b + c into one rounding (FMA)
and divides by constants as a multiply by the reciprocal; the port rounds
every operation on its own. Hence: per-tile partials within 1e-5 of each
row's largest value; classes equal; normals, edge directions and positions
within 1e-5 (eigh, the VU filter and the 3x3 solves could switch branch
where a value sits on a threshold, so up to one column in a thousand may
exceed that, and is counted; on this cloud none does).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ngpd_tpu.config import DenoiseConfig as JaxConfig
from ngpd_tpu.core import pallas_fused as pf
from ngpd_tpu.core.fused import _dist_tile, _kth_smallest
from ngpd_tpu_torch.config import DenoiseConfig
from ngpd_tpu_torch.core.cuda_fused import passes_prologue
from ngpd_tpu_torch.kernels import passes as kp
from ngpd_tpu_torch.kernels import window as kw

from fixtures import cube_corner

torch.set_num_threads(2)

TILE, WINDOW = 128, 128
STRATEGIES = [
    ("flat", "edge", "feature"),
    ("new", "corner", "feature"),
    ("dummy", "edge", "corner"),
    ("flat", "new", "flat"),
    ("new", "flat", "edge"),
]
DELTA_CLASSES = [(), (0,), (0, 1), (0, 1, 2)]
REL_TOL = 1e-5


def _cloud():
    pts, nrm, _ = cube_corner(18, spacing=0.05)
    rng = np.random.default_rng(0)
    return (pts + rng.normal(scale=0.005, size=pts.shape)).astype(np.float32), nrm


@functools.lru_cache(maxsize=None)
def _state(threshold_method="approx"):
    noisy, nrm = _cloud()
    return passes_prologue(noisy, nrm, DenoiseConfig(), tile=TILE, window=WINDOW,
                           threshold_method=threshold_method, device="cpu")


def _j(t):
    return jnp.asarray(t.numpy())


def _t(a):
    return torch.from_numpy(np.array(a))


def _call(kernel, in_specs, out_rows, scratch, *args):
    """One pass through pl.pallas_call in interpret mode, with the grid
    spec of pallas_denoise: prefetched starts and meta=[nv]."""
    win = _state().win
    n = win.n
    wt = win.wt_c
    starts = jnp.clip(jnp.arange(n // TILE, dtype=jnp.int32) * TILE - WINDOW, 0, n - wt)
    out_specs = [pl.BlockSpec((r, TILE), lambda t, *_: (0, t)) for r in out_rows]
    out_shape = [jax.ShapeDtypeStruct((r, n), jnp.float32) for r in out_rows]
    call = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=2,
            grid=(n // TILE,),
            in_specs=in_specs,
            out_specs=tuple(out_specs) if len(out_rows) > 1 else out_specs[0],
            scratch_shapes=scratch,
        ),
        out_shape=tuple(out_shape) if len(out_rows) > 1 else out_shape[0],
        interpret=True,
    )
    out = call(starts, jnp.asarray([win.nv], jnp.int32), *args)
    return tuple(_t(o) for o in out) if len(out_rows) > 1 else _t(out)


_ANY = pl.BlockSpec(memory_space=pl.ANY)
_SCAL = pl.BlockSpec((8, 128), lambda t, *_: (0, 0))


def _scratch(with_cls):
    wt = _state().win.wt_c
    shapes = [pltpu.VMEM((16, TILE), jnp.float32), pltpu.VMEM((24, wt), jnp.float32)]
    if with_cls:
        shapes.append(pltpu.VMEM((8, TILE), jnp.float32))
    return shapes + [pltpu.SemaphoreType.DMA((len(shapes),))]


@functools.lru_cache(maxsize=None)
def _ref_a():
    st = _state()
    wt, nt = st.win.wt_c, st.win.n // TILE
    return _call(
        pf._make_pass_a(TILE, wt, st.win.n, JaxConfig(), num_tiles=nt), [_ANY] * 2,
        (16, 24),
        [pltpu.VMEM((2, 16, TILE), jnp.float32), pltpu.VMEM((2, 24, wt), jnp.float32),
         pltpu.SemaphoreType.DMA((2, 2))],
        _j(st.gq), _j(st.gr),
    )


@functools.lru_cache(maxsize=None)
def _ref_b(needs_delta):
    gq2, gr2 = _ref_a()
    return _call(
        pf._make_pass_b(TILE, _state().win.wt_c, JaxConfig(), needs_delta),
        [_ANY, _ANY, _SCAL], (8, 16), _scratch(False),
        _j(gq2), _j(gr2), jnp.zeros((8, 128), jnp.float32),
    )


def _tile_lane0(parts, rows):
    """The reference's per-tile scalars, lane 0 of each (rows, TILE) block."""
    return parts.reshape(parts.shape[0], -1, TILE)[:rows, :, 0]


def _ref_parts(needs_delta):
    """The reference's pass B partials as (4 nd, num_tiles)."""
    return _tile_lane0(_ref_b(needs_delta)[1], 4 * len(needs_delta))


def _scal_with_centres(needs_delta):
    """d_thr and the centres from the reference's pass B partials, through
    the driver's own delta_scal (pallas_denoise, l.1084-1092)."""
    return kp.delta_scal(_state().d_thr, _ref_parts(needs_delta))


@functools.lru_cache(maxsize=None)
def _ref_c(needs_delta):
    gq2, gr2 = _ref_a()
    cls = _ref_b(needs_delta)[0]
    scal = _scal_with_centres(needs_delta)
    out = _call(
        pf._make_pass_c(TILE, _state().win.wt_c, JaxConfig(), needs_delta),
        [_ANY, _ANY, _ANY, _SCAL], (8,), _scratch(True),
        _j(gq2), _j(gr2), _j(cls), _j(scal),
    )
    return scal, out


def _scal_full(needs_delta):
    """The lag state pass D reads: centres and the deltas from pass C."""
    if not needs_delta:
        return _scal_with_centres(needs_delta)
    mtile = _tile_lane0(_ref_c(needs_delta)[1], len(needs_delta))
    return kp.delta_scal(_state().d_thr, _ref_parts(needs_delta), mtile)


def _flip_share(got, ref, tol, cols=None):
    """Share of columns (of ``cols``, or all) whose largest difference
    exceeds tol, and the largest difference."""
    diff = (got - ref).abs().amax(dim=0)
    diff = diff if cols is None else diff[cols]
    return float((diff > tol).float().mean()), float(diff.max())


def test_geometry_matches_reference():
    """Padding to the tile and window starts as pallas_fused.py:874-884."""
    for n_in, tile, window in [(919, 128, 128), (5000, 256, 128), (300, 128, 512),
                               (1_000_000, 256, 128)]:
        n = -(-n_in // tile) * tile
        wt = min(tile + 2 * window, n)
        want = np.clip(np.arange(n // tile) * tile - window, 0, n - wt)
        win = kw.make_windows(n, n_in, tile, window, 1, "cpu")
        assert win.wt_c == wt and win.n == n and win.nv == n_in
        assert np.array_equal(win.starts.numpy(), want)


def test_packs_match_reference_exactly():
    """build_packs/set_rk produce the reference's GQ/GR rows bit for bit."""
    st = _state()
    pos, nrm = st.sorted.pos.T.contiguous(), st.sorted.nrm.T.contiguous()
    gq_j, gr_j = pf._build_packs(_j(pos), _j(nrm))
    gq_j = pf._set_rk(gq_j, _j(st.rk_feat), _j(st.rk_step))
    assert torch.equal(st.gq, _t(gq_j))
    assert torch.equal(st.gr, _t(gr_j))


@pytest.mark.parametrize("method", ["approx", "exact"])
def test_prologue_matches_reference(method):
    """rk_feat, rk_step and d_thr against the reference's XLA prologue
    (l.888-912) on the same sorted cloud. The reference's window distances
    come from a matrix product whose rounding differs from the port's
    fixed order by ulps, and the thresholds are those distances: 1e-6
    relative. (``approx`` is approx_min_k, exact off the TPU.)"""
    st = _state(method)
    cfg = JaxConfig()
    win, n = st.win, st.win.n
    pos = _j(st.sorted.pos)
    rkf, rk8, ssum, cnt = [], [], 0.0, 0
    for t, off in enumerate(win.starts.tolist()):
        tp, wp = pos[t * TILE : (t + 1) * TILE], pos[off : off + win.wt_c]
        d = _dist_tile(tp, wp, off + jnp.arange(win.wt_c) < win.nv)
        rkf.append(np.asarray(_kth_smallest(d, cfg.feature_k, method)))
        rk8.append(np.asarray(_kth_smallest(d, cfg.step_k, method)))
        d6 = -jax.lax.top_k(-d, 6)[0]
        dist6 = jnp.sqrt(jnp.where(jnp.isfinite(d6), d6, 0.0))
        row_ok = (t * TILE + jnp.arange(TILE)) < win.nv
        ssum += float(jnp.sum(jnp.where(row_ok[:, None], dist6, 0.0)))
        cnt += int(jnp.sum(row_ok)) * 6
    torch.testing.assert_close(st.rk_feat, torch.as_tensor(np.concatenate(rkf)) * 1.05,
                               rtol=1e-6, atol=0.0)
    torch.testing.assert_close(st.rk_step, torch.as_tensor(np.concatenate(rk8)) * 1.05,
                               rtol=1e-6, atol=0.0)
    assert abs(float(st.d_thr) - cfg.d_scale * ssum / cnt) <= 1e-6 * float(st.d_thr)
    assert n == 1024 and win.nv == 919


def test_pass_a_matches_pallas():
    """GQ2/GR2: copied rows equal; the smoothed normals and the rows built
    from them within 1e-5 on all but counted flips."""
    st = _state()
    want_q, want_r = _ref_a()
    got_q, got_r = kp.pass_a(st.gq, st.gr, st.win, DenoiseConfig())
    keep_q = [0, 1, 2, 3, 4, *range(8, 16)]
    assert torch.equal(got_q[keep_q], want_q[keep_q])
    assert torch.equal(got_r[[0, 1, 2, 3, 4, 15, 16, 17]], want_r[[0, 1, 2, 3, 4, 15, 16, 17]])
    assert not want_r[18:].any() and not got_r[18:].any()
    for got, want in ((got_q[5:8], want_q[5:8]), (got_r[5:15], want_r[5:15])):
        share, worst = _flip_share(got, want, 1e-5)
        assert share <= 1e-3 and worst <= 2e-2, (share, worst)


@pytest.mark.parametrize("needs_delta", DELTA_CLASSES, ids=str)
def test_pass_b_matches_pallas(needs_delta):
    """Classes equal; edge directions within 1e-5; per-tile partials
    (sum p_j and count per delta class) within 1e-5 of each row's largest
    value, the counts exactly; the reference's other rows are zero."""
    gq2, gr2 = _ref_a()
    want_cls, want_parts = _ref_b(needs_delta)
    got_cls, got_parts = kp.pass_b(gq2, gr2, _state().win, DenoiseConfig(), needs_delta)
    assert torch.equal(got_cls[0], want_cls[0])
    assert (torch.bincount(got_cls[0].long(), minlength=3) > 0).all()
    share, worst = _flip_share(got_cls[1:4], want_cls[1:4], 1e-5)
    assert share <= 1e-3 and worst <= 2e-2, (share, worst)
    assert not want_cls[4:].any()
    nd = len(needs_delta)
    ptile = _tile_lane0(want_parts, 16)
    assert got_parts.shape == (4 * nd, _state().win.n // TILE)
    assert not ptile[4 * nd :].any()
    if nd:
        want = ptile[: 4 * nd]
        scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
        assert float(((got_parts - want).abs() / scale).max()) < REL_TOL
        assert torch.equal(got_parts[3::4], want[3::4])


@pytest.mark.parametrize("needs_delta", DELTA_CLASSES[1:], ids=str)
def test_pass_c_matches_pallas(needs_delta):
    """Per-tile maxima of |p_j - centre|^2 within 1e-5 of the row's
    largest (XLA's FMA in |p|^2 - 2 p.c + |c|^2 moves them by ulps)."""
    gq2, gr2 = _ref_a()
    cls = _ref_b(needs_delta)[0][0:4].contiguous()
    scal, want = _ref_c(needs_delta)
    got = kp.pass_c(gq2, gr2, cls, scal, _state().win, needs_delta)
    nd = len(needs_delta)
    mtile = _tile_lane0(want, 8)
    assert not mtile[nd:].any()
    scale = mtile[:nd].abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    assert float(((got - mtile[:nd]).abs() / scale).max()) < REL_TOL


@pytest.mark.parametrize("strategy", STRATEGIES, ids="-".join)
def test_pass_d_matches_pallas(strategy):
    """New positions within 1e-5 on all but counted flips (a clamp or a
    solve's guard on its threshold), held class by class, each to 1e-3 of
    its own points. The classes of this cloud are 867 flat, 51 edge and 1
    corner point, so every step of the strategy runs, and the steps of
    the rare classes may show no flip."""
    needs_delta = tuple(c for c in range(3) if strategy[c] in ("flat", "new"))
    gq2, gr2 = _ref_a()
    cls = _ref_b(needs_delta)[0]
    scal = _scal_full(needs_delta)
    want = _call(
        pf._make_pass_d(TILE, _state().win.wt_c, JaxConfig(), strategy, needs_delta),
        [_ANY, _ANY, _ANY, _SCAL], (8,), _scratch(True),
        _j(gq2), _j(gr2), _j(cls), _j(scal),
    )
    got = kp.pass_d(gq2, gr2, cls[0:4].contiguous(), scal, _state().win, DenoiseConfig(),
                    strategy, needs_delta)
    assert not want[3:].any()
    for c in range(3):
        share, worst = _flip_share(got, want[0:3], 1e-5, cls[0] == float(c))
        assert share <= 1e-3 and worst <= 2e-2, (c, share, worst)
    assert float((got - gq2[0:3]).abs().max()) > 1e-3  # the points moved


def _lag_state(needs_delta):
    """A lag state that is not the initial one: the centres and deltas the
    exact-delta passes B and C give on this cloud, each class its own."""
    return _scal_full(needs_delta)


@pytest.mark.parametrize("strategy", STRATEGIES, ids="-".join)
def test_pass_bd_matches_pallas(strategy):
    """The fused pass BD under pallas_denoise's grid spec (l.953-977), for
    0, 1, 2 and 3 delta classes and a lag state that is not the initial
    one. Classes equal; the next packs' carried rows (ones, normals,
    thresholds, zeros) equal; positions and the rows built from them
    within 1e-5 on all but counted flips, class by class; all 5 nd partial
    rows within 1e-5 of each row's largest value, the counts exactly; the
    reference's other partial rows zero and its row 15 the classes."""
    needs_delta = tuple(c for c in range(3) if strategy[c] in ("flat", "new"))
    nd = len(needs_delta)
    st = _state()
    wt, nt = st.win.wt_c, st.win.n // TILE
    gq2, gr2 = _ref_a()
    scal = _lag_state(needs_delta)
    want_q, want_r, want_parts = _call(
        pf._make_pass_bd(TILE, wt, JaxConfig(), strategy, needs_delta, num_tiles=nt),
        [_ANY, _ANY, _SCAL], (16, 24, 16),
        [pltpu.VMEM((2, 16, TILE), jnp.float32), pltpu.VMEM((2, 24, wt), jnp.float32),
         pltpu.SemaphoreType.DMA((2, 2))],
        _j(gq2), _j(gr2), _j(scal),
    )
    got_q, got_r, got_cls, got_parts = kp.pass_bd(gq2, gr2, scal, st.win,
                                                  DenoiseConfig(), strategy, needs_delta)
    assert torch.equal(got_cls, want_parts[15])
    assert set(torch.unique(got_cls).long().tolist()) == {0, 1, 2}
    keep_q = [3, *range(5, 16)]
    assert torch.equal(got_q[keep_q], want_q[keep_q])
    assert torch.equal(got_r[[4, *range(5, 8), *range(9, 15)]],
                       want_r[[4, *range(5, 8), *range(9, 15)]])
    assert not want_r[18:].any() and not got_r[18:].any()
    pad = torch.arange(st.win.n) >= st.win.nv
    assert torch.equal(got_q[0:3, pad], gq2[0:3, pad])  # padding rows pinned
    for c in range(3):
        cols = got_cls == float(c)
        for got, want in ((got_q[0:5], want_q[0:5]), (got_r[[0, 1, 2, 3, 8, 15, 16, 17]],
                                                      want_r[[0, 1, 2, 3, 8, 15, 16, 17]])):
            share, worst = _flip_share(got, want, 1e-5, cols)
            assert share <= 1e-3 and worst <= 2e-2, (c, share, worst)
    assert float((got_q[0:3] - gq2[0:3]).abs().max()) > 1e-3  # the points moved
    ptile = _tile_lane0(want_parts, 15)
    assert got_parts.shape == (5 * nd, nt)
    assert not ptile[5 * nd :].any()
    if nd:
        want = ptile[: 5 * nd]
        scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
        assert float(((got_parts - want).abs() / scale).max()) < REL_TOL
        assert torch.equal(got_parts[3::5], want[3::5])
        assert (got_parts[4::5].amax(dim=1) > 0).all()  # every delta class has a spread


def test_lag_scal_matches_reference_loop():
    """lag_scal builds the next lag state as pallas_denoise does from the
    lane-0 partials (l.1072-1079), and initial_lag_scal the first one
    (l.1040-1056)."""
    rng = np.random.default_rng(3)
    parts = torch.as_tensor(rng.uniform(0.5, 2.0, size=(10, 8)).astype(np.float32))
    d_thr = torch.tensor(0.25)
    got = kp.lag_scal(d_thr, parts)
    pj = jnp.asarray(parts.numpy())
    for ci in range(2):
        base = 5 * ci
        centre = jnp.sum(pj[base : base + 3], axis=1) / jnp.maximum(jnp.sum(pj[base + 3]), 1.0)
        delta = jnp.sqrt(jnp.maximum(jnp.max(pj[base + 4]), 0.0))
        np.testing.assert_allclose(got[4 + ci, 0:3].numpy(), np.asarray(centre), rtol=1e-6)
        np.testing.assert_allclose(float(got[1 + ci, 0]), float(delta), rtol=1e-6)
    assert float(got[0, 0]) == 0.25 and not got[3].any() and not got[6:].any()
    st = _state()
    first = kp.initial_lag_scal(st.gq[0:3], st.win.nv, 2, st.d_thr)
    pos = st.gq[0:3, : st.win.nv]
    centroid = pos.sum(dim=1) / st.win.nv
    torch.testing.assert_close(first[4, 0:3], centroid, rtol=1e-6, atol=0)
    torch.testing.assert_close(first[5, 0:3], centroid, rtol=1e-6, atol=0)
    radius = ((pos - centroid[:, None]) ** 2).sum(dim=0).max().sqrt()
    torch.testing.assert_close(first[1, 0], radius, rtol=1e-6, atol=0)
    assert float(first[2, 0]) == float(first[1, 0]) and float(first[3, 0]) == 0.0
    assert float(first[0, 0]) == float(st.d_thr)


def test_strategies_cover_every_step():
    """With the classes of this cloud, the strategies above run each of
    the six steps on some point, and delta classes 0-3 in number."""
    classes = set(torch.unique(_ref_b(())[0][0]).long().tolist())
    assert classes == {0, 1, 2}
    steps = {s[c] for s in STRATEGIES for c in classes}
    assert steps == {"flat", "edge", "corner", "feature", "new", "dummy"}
    sizes = {sum(s[c] in ("flat", "new") for c in range(3)) for s in STRATEGIES}
    assert sizes == {0, 1, 2, 3}
