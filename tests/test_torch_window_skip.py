"""The word skip of K2 (``csrc/walk_common.cuh``), through its plain copy.

A warp skips a 32-column word of its window when the gap between the
bounding box of its 32 queries and the word's bounding box, less a margin
for the rounding of the computed distance, exceeds its largest threshold.
``window.word_skippable`` is that predicate operation for operation. It
must never skip a word in which ``window._sq_dist`` (the distance whose
masks the kernels match bit for bit) has a column within a query's
threshold: on the bench clouds, on exact ties (integer coordinates), on a
padded cloud, far from the origin where cancellation is largest, and on
drawn boxes.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ngpd_tpu_torch.bench import make_cloud, make_corner_cloud
from ngpd_tpu_torch.config import DenoiseConfig
from ngpd_tpu_torch.core.cuda_fused import prologue
from ngpd_tpu_torch.kernels import window as kw

torch.set_num_threads(2)

CFG = DenoiseConfig(feature_k=16, step_k=8)


def _integer_cloud(n):
    rng = np.random.default_rng(5)
    pts = rng.integers(0, 24, size=(n, 3)).astype(np.float32)
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]], dtype=np.float32), (n, 1))
    return pts, nrm


def _moved(cloud, offset):
    def make(n):
        pts, nrm, _ = cloud(n)
        return pts + np.float32(offset), nrm
    return make


CLOUDS = {
    "roof": lambda n: make_cloud(n)[:2],
    "corners": lambda n: make_corner_cloud(n)[:2],
    "integer": _integer_cloud,
    "roof+30": _moved(make_cloud, 30.0),
    "roof+1000": _moved(make_cloud, 1000.0),
    "corners-300": _moved(make_corner_cloud, -300.0),
}


def _word_hits(pos, thr, win, b, s):
    """(tile // 32, words) bool: some query of the warp has a column of the
    word within its threshold, by ``_sq_dist``."""
    t, words = win.tile, -(-win.wt_c // 32)
    d = kw._sq_dist(pos[:, b * t : (b + 1) * t], pos[:, s : s + win.wt_c])
    d = torch.where(kw._col_valid(s, win, pos.device)[None, :], d, kw._MASKED)
    hit = (d <= thr[b * t : (b + 1) * t, None]) & (d < kw._MASKED)
    hit = torch.nn.functional.pad(hit, (0, words * 32 - win.wt_c))
    return hit.view(t // 32, 32, words, 32).any(dim=3).any(dim=1)


def _check_cloud(pts, nrm, num_valid=None, tile=64, window=96):
    state = prologue(pts, nrm, CFG, num_valid=num_valid, tile=tile, window=window,
                     sub=1, device="cpu")
    pos, rkf, rks, win = state.pack[0:3], state.pack[6], state.pack[7], state.win
    skip = kw.skippable_words(pos, rkf, rks, win)
    assert skip.shape == (win.n // tile, tile // 32, -(-win.wt_c // 32))
    thr = torch.maximum(rkf, rks)
    for b, s in enumerate(win.starts.tolist()):
        wrong = skip[b] & _word_hits(pos, thr, win, b, s)
        assert not bool(wrong.any()), (b, wrong.nonzero().tolist())
    return kw.skipped_word_share(pos, rkf, rks, win)


@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_no_word_with_a_passing_column_is_skipped(cloud):
    pts, nrm = CLOUDS[cloud](2048)
    share = _check_cloud(pts, nrm)
    assert 0.0 <= share < 1.0
    if cloud in ("roof", "corners"):
        assert share > 0.05  # the predicate does skip on a sorted cloud


@pytest.mark.parametrize("window", [96, 99])
def test_padded_cloud_and_ragged_window(window):
    """Padding rows sit at the origin and the columns past a window whose
    width is not a multiple of 32 are zeros: both only widen a box."""
    pts, nrm, _ = make_cloud(2000)
    _check_cloud(pts, nrm, num_valid=1900, window=window)


def test_mask_threshold_is_the_two_tests_in_one():
    rk = torch.tensor([0.0, 1e-3, 5.0, 9.9e29, 1e30, 2e30, float("inf"), float("nan")])
    d = torch.tensor([0.0, 1e-3, 4.0, 9.9e29, float(np.nextafter(np.float32(1e30), np.float32(0))),
                      1e30, float("inf")])
    both = (d[:, None] <= rk[None, :]) & (d[:, None] < 1e30)
    assert torch.equal(d[:, None] <= kw.mask_threshold(rk)[None, :], both)


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), centre=st.floats(-2e3, 2e3),
       spread=st.floats(1e-3, 50.0), gap=st.floats(0.0, 60.0),
       thr_scale=st.floats(1e-4, 30.0))
def test_drawn_boxes_never_skip_a_hit(seed, centre, spread, gap, thr_scale):
    """32 queries in one box and 32 columns in another, `gap` apart along a
    drawn axis, thresholds of the gap's order: a skipped word has no
    column within any query's threshold."""
    rng = np.random.default_rng(seed)
    q = (centre + spread * rng.random((3, 32))).astype(np.float32)
    w = (centre + spread * rng.random((3, 32))).astype(np.float32)
    w[rng.integers(0, 3)] += np.float32(spread + gap)
    thr = (thr_scale * rng.random(32) * max(gap, spread) ** 2).astype(np.float32)
    q, w, thr = torch.as_tensor(q), torch.as_tensor(w), torch.as_tensor(thr)
    d = kw._sq_dist(q, w)
    skip = kw.word_skippable(q.amin(dim=1), q.amax(dim=1), (q * q).sum(dim=0).max(),
                             thr.max(), w.amin(dim=1), w.amax(dim=1),
                             (w * w).sum(dim=0).max())
    assert not (bool(skip) and bool((d <= thr[:, None]).any()))
