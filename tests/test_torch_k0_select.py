"""K0's selection (``csrc/k0.cu``) held to the counting search on the CPU.

K0 finds its three thresholds by selecting the k-th smallest window
distances and replaying the 24-step bisection against them: the search
keeps ``hi = mid`` where ``count(d <= mid) >= k``, which holds exactly
when ``d_(k) <= mid``. The kernel cannot run here, so its arithmetic is
kept under test through ``kernels/window.py::k0_model``, its plain copy
step for step: the lane layout, the bound T, the candidates, the capacity
test, the replay, and the counting search where the kernel takes it.
These tests hold the model to ``k0_plain`` bit for bit on clouds and to
the counting search on random distance rows; ``chip_smoke.py`` holds the
kernel to the model on the card.
"""

import math
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from ngpd_tpu_torch.bench import make_cloud, make_corner_cloud
from ngpd_tpu_torch.config import DenoiseConfig
from ngpd_tpu_torch.core.cuda_fused import prologue
from ngpd_tpu_torch.kernels import build
from ngpd_tpu_torch.kernels import window as kw

torch.set_num_threads(2)

DEFAULT = ("flat", "edge", "feature")


def duplicated_cloud(n: int):
    """Half of ``make_cloud(n)`` as it is, the other half n / 512 of its
    points 256 times each: a query among the copies has 256 equal
    distances, more candidates than K0 keeps, and takes the counting
    search; the others are selected."""
    pts, nrm, _ = make_cloud(n)
    half = n // 2
    copies = slice(half, half + half // 256)
    return (np.concatenate([pts[:half], np.repeat(pts[copies], 256, axis=0)]),
            np.concatenate([nrm[:half], np.repeat(nrm[copies], 256, axis=0)]))


def _state(cloud, n, feature_k, step_k, window=128, num_valid=None):
    if cloud == "duplicated":
        pts, nrm = duplicated_cloud(n)
    elif cloud == "equal":  # every distance 0: every query overflows
        pts, nrm = np.zeros((n, 3), np.float32), np.tile(np.float32([0, 0, 1]), (n, 1))
    else:
        pts, nrm, _ = (make_cloud if cloud == "sphere" else make_corner_cloud)(n)
    cfg = DenoiseConfig(feature_k=feature_k, step_k=step_k)
    return prologue(pts, nrm, cfg, DEFAULT, num_valid=num_valid, window=window, device="cpu")


def _held_to_plain(st, feature_k, step_k) -> kw.K0Selection:
    """The model's rows 0, 1 and 3 (rk_feat, rk_step, cnt6) are k0_plain's
    bit for bit, and T bounds at least K distances of every row the
    selection serves."""
    out, sel = kw.k0_model(st.pack, st.win, feature_k, step_k)
    ref = kw.k0_plain(st.pack, st.win, feature_k, step_k)
    assert torch.equal(out[[0, 1, 3]], ref[[0, 1, 3]])
    big = max(feature_k, step_k, 6)
    if -(-big // 16) <= min(kw.K0_MAX_R, kw.k0_lanes(st.win.wt_c)):
        assert bool((sel.candidates >= big).all())
        assert not bool(sel.slow[sel.candidates <= kw.K0_CAP].any())
    return sel


# wt_c 512 (window 128), 1,280 (the CLI's window 512), 2,304 (the
# shared-memory kernel); r = 1 (feature_k 6 and 16), 2 (32), 3 (48), 4 (64);
# step_k above feature_k; nv inside the last tile's window.
@pytest.mark.parametrize("cloud,n,feature_k,step_k,window,num_valid", [
    ("sphere", 4096, 32, 8, 128, None),
    ("corner", 4096, 32, 8, 128, None),
    ("sphere", 4096, 6, 8, 128, None),
    ("corner", 4096, 16, 8, 512, None),
    ("sphere", 4096, 48, 8, 128, None),
    ("sphere", 4096, 64, 8, 128, 4000),
    ("sphere", 4096, 16, 40, 128, None),
    ("sphere", 4096, 32, 8, 128, 3_877),
    ("sphere", 8192, 16, 8, 1024, None),
])
def test_model_matches_k0_plain(cloud, n, feature_k, step_k, window, num_valid):
    sel = _held_to_plain(_state(cloud, n, feature_k, step_k, window, num_valid),
                         feature_k, step_k)
    # No ties here: the selection serves all but a few queries (feature_k 64
    # overflows K0_CAP on some rows whose window ends in masked columns).
    assert float(sel.slow.float().mean()) < 0.01


def test_ties_send_queries_to_the_counting_search():
    """Hundreds of equal distances overflow the candidates: those queries
    take the counting search, the others are selected, and both give the
    plain version's rows."""
    sel = _held_to_plain(_state("duplicated", 8192, 32, 8), 32, 8)
    assert 0.1 < float(sel.slow.float().mean()) < 0.9
    assert int(sel.candidates.max()) > kw.K0_CAP


def test_all_distances_equal_overflow():
    sel = _held_to_plain(_state("equal", 1024, 32, 8), 32, 8)
    assert bool(sel.slow.all())


def test_k_beyond_the_registers_takes_the_counting_search():
    """K = 65 needs r = 5, more than a lane keeps: every query counts."""
    sel = _held_to_plain(_state("sphere", 2048, 65, 8), 65, 8)
    assert bool(sel.slow.all())


def test_candidates_fit_the_capacity_on_the_main_shape():
    """At feature_k 32 and 512 columns the candidates number ~49 on
    average, far below K0_CAP: the selection serves every query."""
    st = _state("sphere", 16_384, 32, 8)
    _, sel = kw.k0_model(st.pack, st.win, 32, 8)
    assert 32 <= float(sel.candidates.float().mean()) < 64
    assert int(sel.candidates.max()) <= kw.K0_CAP and not bool(sel.slow.any())


@settings(max_examples=60, deadline=None)
@given(seed=hs.integers(0, 2**32 - 1), cpl=hs.sampled_from([4, 8, 16, 72]),
       feature_k=hs.integers(1, 80), step_k=hs.integers(1, 80),
       pool=hs.sampled_from([4, 40, 0]), cap=hs.sampled_from([32, 64, kw.K0_CAP]))
def test_selection_replays_the_counting_search(seed, cpl, feature_k, step_k, pool, cap):
    """On random rows in the lane layout (ties from a small pool of values
    or none, columns past nv at dmax, columns past wt_c at +inf), the
    replayed searches equal the counting search bit for bit, at every
    capacity, and T bounds at least K distances of every row."""
    rng = np.random.default_rng(seed)
    q, w = 8, 32 * cpl
    wt_c = int(rng.integers(1, w + 1))
    live = int(rng.integers(0, wt_c + 1))
    if pool:
        vals = rng.choice(rng.random(pool).astype(np.float32) * 4, size=(q, wt_c))
    else:
        vals = (rng.random((q, wt_c)) * 4).astype(np.float32)
    d = torch.full((q, w), math.inf)
    d[:, :wt_c] = torch.from_numpy(vals.astype(np.float32))
    dmax = torch.where(torch.arange(w) < live, d, 0.0)[:, :wt_c].amax(dim=1) + 1.0
    d[:, live:wt_c] = dmax[:, None]
    sel = kw.k0_select_rows(d, dmax, feature_k, step_k, cap)
    for row, k in zip(sel.rk, (feature_k, step_k, 6)):
        assert torch.equal(row, kw._kth_by_count(d, k, dmax[:, None]))
    big = max(feature_k, step_k, 6)
    if -(-big // 16) <= min(kw.K0_MAX_R, cpl):
        assert bool((sel.candidates >= big).all())
        assert bool(((d <= sel.bound[:, None]).sum(dim=1) >= big).all())
    assert bool(sel.slow[sel.candidates > cap].all())


def test_model_constants_are_the_kernels():
    """The capacity, the largest r and the lanes a window takes are those
    of csrc/k0.cu."""
    src = (build.CSRC / "k0.cu").read_text()
    assert int(re.search(r"constexpr int K0_CAP = (\d+);", src).group(1)) == kw.K0_CAP
    assert int(re.search(r"constexpr int K0_MAX_R = (\d+);", src).group(1)) == kw.K0_MAX_R
    assert [kw.k0_lanes(w) for w in (1, 128, 129, 454, 512, 1280, 2048, 2049, 2304, 4352)] == \
        [4, 4, 8, 16, 16, 64, 64, 65, 72, 136]
