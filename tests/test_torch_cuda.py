"""The port on the card: each CUDA kernel against its plain version, and
the card's denoise against the CPU path. Imports neither JAX nor
ngpd_tpu, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Without a card every test skips (the CUDA kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from ngpd_tpu_torch.bench import make_cloud, make_corner_cloud
from ngpd_tpu_torch.config import DenoiseConfig
from ngpd_tpu_torch.core import hybrid_stages as hs
from ngpd_tpu_torch.core.cuda_fused import denoise_hybrid, prologue
from ngpd_tpu_torch.kernels import hybrid as khy
from ngpd_tpu_torch.kernels import window as kw

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda
STRATEGIES = [("flat", "edge", "feature"), ("new", "corner", "feature"),
              ("dummy", "edge", "corner"), ("flat", "new", "flat")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA window kernels have no CPU mode")
    return torch.device("cuda")


# Window 512 gives wt_c 1,280 (40 words of 32 columns); window 99 gives
# 454, neither a multiple of 32 nor of 4 (a masked last word, an aligned
# row pitch); 15,877 valid points end 5 columns into the last tile's window.
@pytest.mark.parametrize("window,num_valid", [(128, None), (512, None), (99, None),
                                              (128, 15_877)])
@pytest.mark.parametrize("strategy", STRATEGIES, ids="-".join)
def test_kernels_match_plain(cuda_device, strategy, window, num_valid):
    """Thresholds and counts are computed in the same order with the same
    rounding on both sides, so K0's rows other than the edge sums match
    exactly; sums run in another order, so they agree to 1e-5 of each
    row's largest value."""
    noisy, nrm, _ = make_cloud(16_384)
    cfg = DenoiseConfig(feature_k=32, step_k=8)
    st = prologue(noisy, nrm, cfg, strategy, num_valid=num_valid, window=window,
                  device=cuda_device)
    pack, win = st.pack, st.win
    got0 = kw.k0(pack, win, cfg.feature_k, cfg.step_k)
    ref0 = kw.k0_plain(pack, win, cfg.feature_k, cfg.step_k)
    assert torch.equal(got0[[0, 1, 3]], ref0[[0, 1, 3]])
    torch.testing.assert_close(got0[2], ref0[2], rtol=1e-5, atol=1e-6)
    cos_rho = kw.cos_f32(cfg.angle)
    got1 = kw.k1(pack, win, cfg.angle)
    torch.testing.assert_close(got1, kw.k1_plain(pack, win, cos_rho), rtol=1e-5, atol=1e-6)
    pack2 = hs.vu_stage(got1, pack, cfg)
    nd = len(st.needs_delta)
    got2 = kw.k2(pack2, st.scal, win, cfg.angle, strategy, nd)
    ref2 = kw.k2_plain(pack2, st.scal, win, cos_rho, strategy, nd)
    scale = ref2.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    assert float(((got2 - ref2).abs() / scale).max()) < 1e-5


@pytest.mark.parametrize("lagged", [False, True])
def test_card_denoise_matches_cpu(cuda_device, lagged):
    """The mask-flip bound of the reference's ladder: >= 99% classes
    equal, >= 99.9% of points within 2e-3, all within 2e-2."""
    noisy, nrm, _ = make_cloud(16_384)
    khy.reset_launch_counts()
    g, _, gc = denoise_hybrid(noisy, nrm, iterations=2, lagged_nvt1=lagged,
                              device=cuda_device)
    assert khy.LAUNCHES == {"hybrid_vu": 2, "hybrid_update": 2}  # the card took the kernels
    c, _, cc = denoise_hybrid(noisy, nrm, iterations=2, lagged_nvt1=lagged,
                              device="cpu")
    diff = (g.cpu() - c).abs().amax(dim=1).numpy()
    assert np.mean(gc.cpu().numpy() == cc.numpy()) >= 0.99
    assert np.mean(diff <= 2e-3) >= 0.999 and diff.max() <= 2e-2


# The per-point stage kernels against the eager stages on the card: a roof
# of 131,072 points (the main cell's shape, nearly all flat) and tiled cube
# corners, where every class has hundreds of points; the default strategy
# and one that takes the new, corner and dummy steps.
STAGE_CLOUDS = {"roof": (make_cloud, 131_072), "corners": (make_corner_cloud, 65_536)}
STAGE_STRATEGIES = [("flat", "edge", "feature"), ("new", "corner", "dummy")]


@pytest.mark.parametrize("lagged", [False, True])
@pytest.mark.parametrize("strategy", STAGE_STRATEGIES, ids="-".join)
@pytest.mark.parametrize("cloud", list(STAGE_CLOUDS))
def test_card_hybrid_stage_kernels_match_the_eager_stages(cuda_device, cloud, strategy,
                                                          lagged):
    """``kernels/hybrid.py`` against ``core/hybrid_stages.py`` run eagerly on
    the same card tensors, one launch each. Both round every operation on
    its own in the same order, divide by the constants 3 and 6 as PyTorch's
    CUDA kernels do and call the same acosf and cosf, so the post-VU pack,
    the next pack and the classes are equal bit for bit. Only the lag
    state's centres are summed in another order (per block of 256 points,
    then over the blocks): within 2e-6 of the cloud's extent; d_thr and the
    deltas (maxima) are equal. Under lagged NVT1 the VU stage reads K2's
    t6 rows, a view with K2's row pitch, instead of K1's output."""
    maker, n = STAGE_CLOUDS[cloud]
    noisy, nrm, _ = maker(n)
    cfg = DenoiseConfig(feature_k=32, step_k=8)
    st = prologue(noisy, nrm, cfg, strategy, num_valid=n - 100, device=cuda_device)
    nd, lay, win = len(st.needs_delta), st.lay, st.win
    t6 = kw.k1(st.pack, win, cfg.angle)
    if lagged:
        first = kw.k2(hs.vu_stage(t6, st.pack, cfg), st.scal, win, cfg.angle, strategy, nd)
        t6 = first[lay["t6"] : lay["t6"] + 6]
    before = dict(khy.LAUNCHES)
    ref2 = hs.vu_stage(t6, st.pack, cfg)
    got2 = khy.vu_stage(t6, st.pack, cfg)
    assert torch.equal(got2, ref2)
    k2 = kw.k2(ref2, st.scal, win, cfg.angle, strategy, nd)
    ref = hs.update_stage(k2, ref2, st.d_thr, cfg, strategy, st.needs_delta, lay, win.nv)
    got = khy.update_stage(k2, ref2, st.d_thr, cfg, strategy, st.needs_delta, lay, win.nv)
    torch.cuda.synchronize()
    assert khy.LAUNCHES == {k: v + 1 for k, v in before.items()}
    if cloud == "corners":
        assert all(int((ref[2][: win.nv] == c).sum()) >= 100 for c in range(3))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])
    assert torch.equal(got[1][0:4, 0], ref[1][0:4, 0])
    extent = float(ref2[0:3, : win.nv].abs().max())
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=2e-6 * extent)


@pytest.mark.parametrize("lagged", [False, True])
def test_card_hybrid_runs_each_stage_kernel_once_an_iteration(cuda_device, lagged):
    """20 iterations: one launch of each stage kernel an iteration, K1 once
    under lagged NVT1, K2 every iteration; the output is finite."""
    noisy, nrm, _ = make_cloud(16_384)
    kw.reset_launch_counts()
    khy.reset_launch_counts()
    out = denoise_hybrid(noisy, nrm, iterations=20, lagged_nvt1=lagged, device=cuda_device)
    torch.cuda.synchronize()
    assert khy.LAUNCHES == {"hybrid_vu": 20, "hybrid_update": 20}
    assert kw.LAUNCHES == {"k0": 1, "k1": 1 if lagged else 20, "k2": 20}
    assert all(bool(torch.isfinite(x.float()).all()) for x in out)


def _flips(got, ref, tol, cols=None):
    """Share of columns (of ``cols``, or all) whose largest difference
    exceeds tol, and the largest difference. Equal values differ by 0,
    infinite ones too (a padding row's carried threshold is +inf where its
    window holds fewer than k valid columns)."""
    diff = torch.where(got == ref, 0.0, (got - ref).abs()).amax(dim=0)
    diff = diff if cols is None else diff[cols]
    if not diff.numel():
        return 0.0, 0.0
    return float((diff > tol).float().mean()), float(diff.max())


@pytest.mark.parametrize("tile,window", [(256, 128), (128, 512), (512, 64)])
@pytest.mark.parametrize("strategy", STRATEGIES, ids="-".join)
def test_pass_kernels_match_plain(cuda_device, strategy, tile, window):
    """Each pass kernel against its plain version on the same inputs, each
    fed the plain output of the pass before, on tiled cube corners where
    every class has over a hundred points. Masks and the centre maxima
    are computed in the same order with the same rounding, so pass C
    matches exactly; sums run in another order (1e-5 of each row's
    largest value); eigh, the VU filter and the 3x3 solves switch branch
    where a value sits on a threshold, so >= 99.9% of normals and classes,
    of the edge directions of points both call edge, and of each class's
    positions agree to 1e-5, and all of them to 2e-2.
    Tile 128 with window 512 stages 92 KB of window rows (above the 48 KB
    default); tile 512 runs two query rows a thread; the cloud is padded
    to the tile with trailing rows declared padding."""
    from ngpd_tpu_torch.bench import make_corner_cloud
    from ngpd_tpu_torch.core.cuda_fused import passes_prologue
    from ngpd_tpu_torch.kernels import passes as kp

    noisy, nrm, _ = make_corner_cloud(16_000)
    cfg = DenoiseConfig(feature_k=32, step_k=8)
    st = passes_prologue(noisy, nrm, cfg, strategy, num_valid=15_900,
                         tile=tile, window=window, device=cuda_device)
    win, nd = st.win, st.needs_delta
    ref_a = kp.pass_a_plain(st.gq, st.gr, win, cfg)
    got_a = kp.pass_a(st.gq, st.gr, win, cfg)
    for got, ref in zip(got_a, ref_a):
        share, worst = _flips(got, ref, 1e-5)
        assert share <= 1e-3 and worst <= 2e-2
    gq2, gr2 = ref_a
    ref_cls, ref_parts = kp.pass_b_plain(gq2, gr2, win, cfg, nd)
    got_cls, got_parts = kp.pass_b(gq2, gr2, win, cfg, nd)
    same = got_cls[0] == ref_cls[0]
    assert float(same.float().mean()) >= 0.999
    classes = [ref_cls[0] == float(c) for c in range(3)]
    valid = torch.arange(win.n, device=cuda_device) < win.nv
    assert all(int((m & valid).sum()) >= 100 for m in classes)
    share, worst = _flips(got_cls[1:4], ref_cls[1:4], 1e-5, classes[1] & same)
    assert share <= 1e-3 and worst <= 2e-2  # edge directions
    same_tiles = same.reshape(-1, win.tile).all(dim=1)
    if nd:
        scale = ref_parts.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
        rel = ((got_parts - ref_parts).abs() / scale)[:, same_tiles]
        assert float(rel.max()) < 1e-5
    scal = kp.delta_scal(st.d_thr, ref_parts)
    if nd:
        ref_c = kp.pass_c_plain(gq2, gr2, ref_cls, scal, win, nd)
        got_c = kp.pass_c(gq2, gr2, ref_cls, scal, win, nd)
        assert torch.equal(got_c, ref_c)
        scal = kp.delta_scal(st.d_thr, ref_parts, ref_c)
    ref_d = kp.pass_d_plain(gq2, gr2, ref_cls, scal, win, cfg, strategy, nd)
    got_d = kp.pass_d(gq2, gr2, ref_cls, scal, win, cfg, strategy, nd)
    for cols in classes:
        share, worst = _flips(got_d, ref_d, 1e-5, cols)
        assert share <= 1e-3 and worst <= 2e-2


# Beside the shapes of the other passes: wt 454 (window 99: a masked last
# word), wt 1,280 (40 words), 15,621 valid points (5 columns into the last
# tile's window), and wt 2,928 (tile 128, window 1,400), too wide for the
# step bits to stay in shared memory beside it, so the second accumulation
# scans again.
@pytest.mark.parametrize("tile,window,num_valid", [
    (256, 128, 15_900), (128, 512, 15_900), (512, 64, 15_900), (256, 99, 15_900),
    (256, 512, 15_900), (256, 128, 15_621), (128, 1_400, 15_900)])
@pytest.mark.parametrize("strategy", STRATEGIES, ids="-".join)
def test_pass_bd_matches_plain(cuda_device, strategy, tile, window, num_valid):
    """The fused pass BD against its plain version on the packs the plain
    pass A gives, with a lag state that is not the initial one (the plain
    version's own partials after one pass): classes >= 99.9% equal; on the
    points whose class agrees, each class's next positions within 1e-5 on
    >= 99.9% and within 2e-2 on all; the next packs bit for bit the packs
    of those positions with the normals, ones and thresholds carried
    (``next_packs``; every product and sum is rounded on its own on both
    sides); padding rows pinned; the partials of tiles without a class
    flip within 1e-5 of each row's largest value."""
    from ngpd_tpu_torch.bench import make_corner_cloud
    from ngpd_tpu_torch.core.cuda_fused import passes_prologue
    from ngpd_tpu_torch.kernels import passes as kp

    noisy, nrm, _ = make_corner_cloud(16_000)
    cfg = DenoiseConfig(feature_k=32, step_k=8)
    st = passes_prologue(noisy, nrm, cfg, strategy, num_valid=num_valid,
                         tile=tile, window=window, device=cuda_device)
    win, nd = st.win, st.needs_delta
    gq2, gr2 = kp.pass_a_plain(st.gq, st.gr, win, cfg)
    scal0 = kp.initial_lag_scal(st.gq[0:3], win.nv, len(nd), st.d_thr)
    scal = kp.lag_scal(st.d_thr, kp.pass_bd_plain(gq2, gr2, scal0, win, cfg, strategy, nd)[3])
    ref_q, _, ref_cls, ref_parts = kp.pass_bd_plain(gq2, gr2, scal, win, cfg, strategy, nd)
    got_q, got_r, got_cls, got_parts = kp.pass_bd(gq2, gr2, scal, win, cfg, strategy, nd)
    torch.cuda.synchronize()
    same = got_cls == ref_cls
    assert float(same.float().mean()) >= 0.999
    want_q, want_r = kp.next_packs(got_q[0:3], gq2)
    assert torch.equal(got_q, want_q) and torch.equal(got_r, want_r)
    pad = torch.arange(win.n, device=cuda_device) >= win.nv
    assert torch.equal(got_q[0:3, pad], gq2[0:3, pad])
    for c in range(3):
        cols = (ref_cls == float(c)) & same
        assert int(cols.sum()) >= 100
        share, worst = _flips(got_q[0:3], ref_q[0:3], 1e-5, cols)
        assert share <= 1e-3 and worst <= 2e-2
    if nd:
        same_tiles = same.reshape(-1, win.tile).all(dim=1)
        scale = ref_parts.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
        rel = ((got_parts - ref_parts).abs() / scale)[:, same_tiles]
        assert float(rel.max()) < 1e-5


@pytest.mark.parametrize("tile,window,num_valid", [
    (256, 128, 15_900), (128, 512, 15_900), (512, 64, 15_900), (256, 99, 15_900),
    (256, 512, 15_900), (256, 128, 15_621), (128, 1_400, 15_900)])
@pytest.mark.parametrize("strategy", STRATEGIES, ids="-".join)
def test_pass_b_and_d_match_plain(cuda_device, strategy, tile, window, num_valid):
    """Passes B and D, rebuilt on pass BD's walk, against their plain
    versions at BD's shapes (at wt 2,928 pass B scans its step bits again),
    each fed the plain output of the passes before: classes >= 99.9%
    equal; the edge directions of points both call edge, and each class's
    positions, within 1e-5 on >= 99.9% and within 2e-2 on all; the
    partials of tiles without a class flip within 1e-5 of each row's
    largest value."""
    from ngpd_tpu_torch.bench import make_corner_cloud
    from ngpd_tpu_torch.core.cuda_fused import passes_prologue
    from ngpd_tpu_torch.kernels import passes as kp

    noisy, nrm, _ = make_corner_cloud(16_000)
    cfg = DenoiseConfig(feature_k=32, step_k=8)
    st = passes_prologue(noisy, nrm, cfg, strategy, num_valid=num_valid,
                         tile=tile, window=window, device=cuda_device)
    win, nd = st.win, st.needs_delta
    gq2, gr2 = kp.pass_a_plain(st.gq, st.gr, win, cfg)
    ref_cls, ref_parts = kp.pass_b_plain(gq2, gr2, win, cfg, nd)
    got_cls, got_parts = kp.pass_b(gq2, gr2, win, cfg, nd)
    same = got_cls[0] == ref_cls[0]
    assert float(same.float().mean()) >= 0.999
    classes = [ref_cls[0] == float(c) for c in range(3)]
    share, worst = _flips(got_cls[1:4], ref_cls[1:4], 1e-5, classes[1] & same)
    assert share <= 1e-3 and worst <= 2e-2
    if nd:
        same_tiles = same.reshape(-1, win.tile).all(dim=1)
        scale = ref_parts.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
        rel = ((got_parts - ref_parts).abs() / scale)[:, same_tiles]
        assert float(rel.max()) < 1e-5
    scal = kp.delta_scal(st.d_thr, ref_parts)
    if nd:
        scal = kp.delta_scal(st.d_thr, ref_parts,
                             kp.pass_c_plain(gq2, gr2, ref_cls, scal, win, nd))
    ref_d = kp.pass_d_plain(gq2, gr2, ref_cls, scal, win, cfg, strategy, nd)
    got_d = kp.pass_d(gq2, gr2, ref_cls, scal, win, cfg, strategy, nd)
    for cols in classes:
        assert int(cols.sum()) >= 100
        share, worst = _flips(got_d, ref_d, 1e-5, cols)
        assert share <= 1e-3 and worst <= 2e-2


# The windows past 64 columns a lane, K0's shared-memory path: the CLI's
# --window 1024 (wt_c 2,304) and --window 2048 (wt_c 4,352) at tile 256.
@pytest.mark.parametrize("window,num_valid", [(1024, None), (2048, None), (1024, 15_877)])
def test_k0_wide_windows_match_plain(cuda_device, window, num_valid):
    """K0 past 2,048 window columns keeps each warp's distances in shared
    memory: the thresholds and counts are those of k0_plain bit for bit,
    the edge sums within 1e-5 (their warp sum runs in another order than
    the plain row sum). The hybrid then runs at that window on the card."""
    noisy, nrm, _ = make_cloud(16_384)
    cfg = DenoiseConfig(feature_k=32, step_k=8)
    st = prologue(noisy, nrm, cfg, STRATEGIES[0], num_valid=num_valid, window=window,
                  device=cuda_device)
    assert st.win.wt_c == 256 + 2 * window
    got = kw.k0(st.pack, st.win, cfg.feature_k, cfg.step_k)
    ref = kw.k0_plain(st.pack, st.win, cfg.feature_k, cfg.step_k)
    assert torch.equal(got[[0, 1, 3, 4, 5, 6, 7]], ref[[0, 1, 3, 4, 5, 6, 7]])
    torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=1e-6)
    out, _, _ = denoise_hybrid(noisy, nrm, cfg, iterations=1, window=window,
                               num_valid=num_valid, device=cuda_device)
    assert bool(torch.isfinite(out).all())


def test_k0_refuses_a_window_past_shared_memory(cuda_device):
    """At wt_c 12,256 (window 6,000) not even one warp's row of distances
    fits beside the window: the launch function refuses it, the wrapper
    (K0 runs in the prologue) raises naming the limit, no launch is
    counted and the device stays usable."""
    noisy, nrm, _ = make_cloud(16_384)
    cfg = DenoiseConfig(feature_k=32, step_k=8)
    before = dict(kw.LAUNCHES)
    with pytest.raises(ValueError, match="window of 12256 columns.*K0_SMEM_LIMIT"):
        prologue(noisy, nrm, cfg, STRATEGIES[0], window=6_000, device=cuda_device)
    assert kw.LAUNCHES == before
    st = prologue(noisy, nrm, cfg, STRATEGIES[0], window=1_024, device=cuda_device)
    assert kw.LAUNCHES["k0"] == before["k0"] + 1
    assert bool(torch.isfinite(st.pack).all())


def _duplicated_cloud(n: int):
    """Half of make_cloud(n), the other half n / 512 of its points 256
    times each."""
    pts, nrm, _ = make_cloud(n)
    half = n // 2
    copies = slice(half, half + half // 256)
    return (np.concatenate([pts[:half], np.repeat(pts[copies], 256, axis=0)]),
            np.concatenate([nrm[:half], np.repeat(nrm[copies], 256, axis=0)]))


# K0 selects its order statistics and replays the bisection (csrc/k0.cu):
# feature_k 6 and 64 (r = 1 and r = 4), a cloud whose copies of a point
# give hundreds of equal distances (those queries take the counting
# search), and 15,877 valid points, where fewer valid columns than
# feature_k reach the last tile.
@pytest.mark.parametrize("feature_k,cloud,num_valid", [
    (6, "sphere", None), (64, "sphere", None), (32, "duplicated", None),
    (32, "sphere", 15_877)])
def test_k0_selection_matches_plain(cuda_device, feature_k, cloud, num_valid):
    """Rows 0, 1 and 3 (rk_feat, rk_step, cnt6) of K0 equal k0_plain's bit
    for bit, and k0_model's, which says which queries were selected."""
    if cloud == "duplicated":
        noisy, nrm = _duplicated_cloud(16_384)
    else:
        noisy, nrm, _ = make_cloud(16_384)
    cfg = DenoiseConfig(feature_k=feature_k, step_k=8)
    st = prologue(noisy, nrm, cfg, STRATEGIES[0], num_valid=num_valid, device=cuda_device)
    got = kw.k0(st.pack, st.win, feature_k, cfg.step_k)
    ref = kw.k0_plain(st.pack, st.win, feature_k, cfg.step_k)
    assert torch.equal(got[[0, 1, 3]], ref[[0, 1, 3]])
    model, sel = kw.k0_model(st.pack, st.win, feature_k, cfg.step_k)
    assert torch.equal(model[[0, 1, 3]], got[[0, 1, 3]])
    if cloud == "duplicated":
        assert 0.1 < float(sel.slow.float().mean()) < 0.9


@pytest.mark.parametrize("tile,window,num_valid", [
    (256, 128, 15_900), (128, 512, 15_900), (512, 64, 15_900), (256, 99, 15_900),
    (256, 512, 15_900), (256, 128, 15_621), (128, 1_400, 15_900)])
@pytest.mark.parametrize("strategy", STRATEGIES, ids="-".join)
def test_pass_a_and_c_match_plain(cuda_device, strategy, tile, window, num_valid):
    """Passes A and C, rebuilt on the walk, against their plain versions
    at BD's shapes, pass C fed the plain outputs of passes A and B: pass
    A's packs within 1e-5 on >= 99.9% of the points and within 2e-2 on
    all (the eigensolver and the VU filter switch branch on a threshold);
    pass C's maxima bit for bit (a max is exact and the masks are)."""
    from ngpd_tpu_torch.bench import make_corner_cloud
    from ngpd_tpu_torch.core.cuda_fused import passes_prologue
    from ngpd_tpu_torch.kernels import passes as kp

    noisy, nrm, _ = make_corner_cloud(16_000)
    cfg = DenoiseConfig(feature_k=32, step_k=8)
    st = passes_prologue(noisy, nrm, cfg, strategy, num_valid=num_valid,
                         tile=tile, window=window, device=cuda_device)
    win, nd = st.win, st.needs_delta
    ref_a = kp.pass_a_plain(st.gq, st.gr, win, cfg)
    got_a = kp.pass_a(st.gq, st.gr, win, cfg)
    for got, ref in zip(got_a, ref_a):
        share, worst = _flips(got, ref, 1e-5)
        assert share <= 1e-3 and worst <= 2e-2
    if not nd:
        return
    gq2, gr2 = ref_a
    cls, parts = kp.pass_b_plain(gq2, gr2, win, cfg, nd)
    scal = kp.delta_scal(st.d_thr, parts)
    assert torch.equal(kp.pass_c(gq2, gr2, cls, scal, win, nd),
                       kp.pass_c_plain(gq2, gr2, cls, scal, win, nd))


@pytest.mark.parametrize("delta_mode", ["exact", "lagged"])
@pytest.mark.parametrize("n_in,num_valid", [(16_384, None), (16_000, 15_900)])
def test_card_passes_match_cpu(cuda_device, n_in, num_valid, delta_mode):
    """denoise_passes on the card against the CPU path, under the
    hybrid's mask-flip bound, on a cloud of whole tiles and on a padded
    one, in both delta modes."""
    from ngpd_tpu_torch.core.cuda_fused import denoise_passes

    noisy, nrm, _ = make_cloud(16_384)
    noisy, nrm = noisy[:n_in], nrm[:n_in]
    g, _, gc = denoise_passes(noisy, nrm, iterations=2, num_valid=num_valid,
                              delta_mode=delta_mode, device=cuda_device)
    c, _, cc = denoise_passes(noisy, nrm, iterations=2, num_valid=num_valid,
                              delta_mode=delta_mode, device="cpu")
    diff = (g.cpu() - c).abs().amax(dim=1).numpy()
    assert np.mean(gc.cpu().numpy() == cc.numpy()) >= 0.99
    assert np.mean(diff <= 2e-3) >= 0.999 and diff.max() <= 2e-2


@pytest.mark.parametrize("exclude_self", [False, True])
def test_card_knn_matches_cpu(cuda_device, exclude_self):
    """knn and knn_grid on the card against the CPU: the distance block is
    three products and two sums a pair, rounded alike on both, and the
    selection breaks ties by position, so indices and distances are equal
    bit for bit, on a cloud with exact ties (an integer grid) too."""
    from ngpd_tpu_torch.ops.knn import estimate_cell_size, knn, knn_grid

    noisy, _, _ = make_cloud(16_384)
    g = np.arange(12, dtype=np.float32)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3)
    for pts, k in ((noisy, 16), (grid, 10)):
        c = torch.as_tensor(pts)
        cn, cd = knn(c, k, exclude_self=exclude_self, num_valid=len(pts) - 50)
        gn, gd = knn(c.to(cuda_device), k, exclude_self=exclude_self,
                     num_valid=len(pts) - 50)
        assert gn.idx.device.type == "cuda"
        assert torch.equal(gn.idx.cpu(), cn.idx) and torch.equal(gn.mask.cpu(), cn.mask)
        assert torch.equal(gd.cpu(), cd)
    cell = float(estimate_cell_size(torch.as_tensor(noisy), 16))
    assert float(estimate_cell_size(torch.as_tensor(noisy).to(cuda_device), 16)) == cell
    cn, cd = knn_grid(torch.as_tensor(noisy), 16, cell, exclude_self=exclude_self)
    gn, gd = knn_grid(torch.as_tensor(noisy).to(cuda_device), 16, cell,
                      exclude_self=exclude_self)
    assert torch.equal(gn.idx.cpu(), cn.idx) and torch.equal(gd.cpu(), cd)


def test_card_dense_denoise_matches_cpu(cuda_device):
    """The dense (N, k) pipeline on the card against the CPU: plain torch
    on both, sums in another order; classes >= 99.9% equal and positions
    within 1e-5 on those points."""
    from ngpd_tpu_torch.core.pipeline import denoise

    noisy, nrm, _ = make_cloud(16_384)
    g, gn, gc = denoise(noisy, nrm, iterations=2, device=cuda_device)
    c, cn, cc = denoise(noisy, nrm, iterations=2, device="cpu")
    same = gc.cpu() == cc
    assert float(same.float().mean()) >= 0.999
    diff = (g.cpu() - c).abs().amax(dim=1)
    assert float((diff[same] <= 1e-5).float().mean()) >= 0.999 and float(diff.max()) <= 2e-2


def test_card_mesh_cascade_matches_cpu(cuda_device):
    """The two-pass mesh cascade (plain torch) on an icosphere(3), card
    against CPU: Ea within 0.01 degrees, the vertices within the
    cascade's own spread under a one-ulp change of its input, read on the
    card."""
    from ngpd_tpu_torch import bench
    from ngpd_tpu_torch.meshproc.metrics import mean_angular_error

    clean, noisy = bench.mesh_workload(3)
    on_card = bench.mesh_cascade(cuda_device)
    g = on_card(noisy).to("cpu")
    c = bench.mesh_cascade("cpu")(noisy)
    spreads = [on_card(noisy.with_vertices(torch.as_tensor(bench.nudged(noisy.v, s)))).v.cpu()
               for s in bench.SPREAD_SEEDS]
    rec = bench.within_spread(g.v, c.v, spreads, base=g.v)
    assert rec["ok"] and torch.isfinite(g.v).all(), rec
    ea_g, ea_c = (float(mean_angular_error(m, clean)) for m in (g, c))
    assert abs(ea_g - ea_c) <= bench.MESH_EA_TOL and ea_g < float(
        mean_angular_error(noisy, clean)) / 2


def test_card_patch2normal_forward_matches_cpu(cuda_device):
    """The full-width Patch2Normal (seeded) on identical patch inputs, card
    against CPU: raw outputs within 2e-4, the bound the CPU tests hold the
    model to against ngpd_tpu."""
    from ngpd_tpu_torch.core.patches import extract_patches
    from ngpd_tpu_torch.learn.predict import estimated_normals
    from ngpd_tpu_torch.models.patch2normal import init_patch2normal

    noisy, _, _ = make_cloud(2048)
    pts = torch.as_tensor(noisy)
    b = extract_patches(pts, estimated_normals(pts), device="cpu")
    args = (b.x, b.nbr_idx, b.nbr_mask, b.node_mask)
    model = init_patch2normal(seed=0)
    with torch.no_grad():
        want = model(*args)
        got = model.to(cuda_device)(*(a.to(cuda_device) for a in args)).cpu()
    assert float((got - want).abs().max()) <= 2e-4


def test_card_point_normals_match_cpu(cuda_device):
    """``predict_cloud_normals`` with estimated normals on 1,024 points,
    card against CPU, within the path's own spread under one-ulp nudges of
    the positions, read on the card."""
    from ngpd_tpu_torch import bench
    from ngpd_tpu_torch.learn.predict import predict_cloud_normals
    from ngpd_tpu_torch.models.patch2normal import init_patch2normal

    noisy, _, _ = make_cloud(1024)
    model = init_patch2normal(seed=0)

    def run(pts, device):
        return predict_cloud_normals(model, torch.as_tensor(pts), device=device).cpu()

    g = run(noisy, cuda_device)
    c = run(noisy, "cpu")
    spreads = [run(bench.nudged(noisy, s), cuda_device) for s in bench.SPREAD_SEEDS]
    rec = bench.within_spread(g.numpy(), c.numpy(), [s.numpy() for s in spreads],
                              base=g.numpy(), median=bench.NORMAL_SPREAD_MEDIAN,
                              largest=bench.NORMAL_SPREAD_MAX)
    assert rec["ok"] and torch.isfinite(g).all(), rec
    assert float((g.norm(dim=1) - 1).abs().max()) <= 1e-5


@pytest.mark.parametrize("kind", ["patch2normal", "dgcnn"])
def test_card_training_step_matches_cpu(cuda_device, monkeypatch, kind):
    """One training step at a narrow width (Patch2Normal hidden 16-64, the
    DGCNN at emb_dims 64, 64 patches, dropout 0.5 with the same keep
    masks), card against CPU under chip_smoke's ``judge_train_step``, held
    to the CPU's own spread under a one-ulp nudge of the batch."""
    import chip_smoke as cs
    from ngpd_tpu_torch.config import ModelConfig

    monkeypatch.setattr(cs, "TRAIN_REF_P2N_CFG",
                        ModelConfig(hidden=(16, 16, 32, 32, 32, 32, 64, 32, 16)))
    monkeypatch.setattr(cs, "TRAIN_REF_EMB", 64)
    monkeypatch.setattr(cs, "MESH_TRAIN_BATCH", 64)
    weights, batch, keep = cs.train_reference_inputs()[kind]
    want = cs.train_step_on(kind, "cpu", weights, batch, keep)
    spread = cs.compare_train_steps(cs.train_step_on(
        kind, "cpu", weights, cs.nudged_batch(kind, batch, 9), keep), want)
    got = cs.train_step_on(kind, "cuda", weights, batch, keep)
    rec = cs.judge_train_step(kind, got, want, spread)
    assert rec["ok"], (rec, spread)
    if kind == "dgcnn":
        assert cs.fast_variance_probe("cuda")["ok"]


def test_card_graphed_patch2normal_steps_give_the_eager_steps_bits(cuda_device, monkeypatch):
    """Three Patch2Normal train steps at the full widths, batch 64, with
    masked nodes and edges: the steps whose forward and backward replay
    CUDA graphs against the eager steps, bit for bit (the losses, every
    parameter and running statistic), with the eager steps' edge-block
    launch counts; ``GRAPHS`` counts one capture, then a replay a step."""
    from ngpd_tpu_torch.kernels import graph
    from ngpd_tpu_torch.learn import train as tr
    from ngpd_tpu_torch.models.patch2normal import init_patch2normal

    g = torch.Generator().manual_seed(3)
    batches = []
    for _ in range(3):
        node = torch.rand((64, 64), generator=g) < 0.8
        node[:, 0] = True
        batches.append({"x": torch.randn((64, 64, 8), generator=g) * node[..., None],
                        "nbr_idx": torch.randint(0, 64, (64, 64, 12), generator=g),
                        "nbr_mask": torch.rand((64, 64, 12), generator=g) < 0.9,
                        "node_mask": node,
                        "y": torch.nn.functional.normalize(torch.randn((64, 3), generator=g),
                                                           dim=1)})

    def steps():
        model = init_patch2normal(seed=4).to(cuda_device)
        state = tr.new_state(model, 1e-3, 0, cuda_device)
        before, losses = dict(graph.LAUNCHES), []
        for b in batches:
            batch = {k: v.to(cuda_device) for k, v in b.items()}
            losses.append(tr.train_step(state, batch)[1]["custom_val_loss"])
        torch.cuda.synchronize()
        return graph.LAUNCHES["edge_block"] - before["edge_block"], [torch.stack(losses)] + [
            t.detach().clone() for t in model.state_dict().values()]

    counted = dict(tr.GRAPHS)
    graphed_launches, graphed = steps()
    assert tr.GRAPHS == {"capture": counted["capture"] + 1, "replay": counted["replay"] + 3}
    monkeypatch.setattr(tr, "graphed_forward", lambda state, inputs, keep: state.model)
    eager_launches, eager = steps()
    assert tr.GRAPHS == {"capture": counted["capture"] + 1, "replay": counted["replay"] + 3}
    # the capture's three warm-up forwards ran their six blocks each too
    assert eager_launches == 18 and graphed_launches == 18 + 3 * 6
    assert all(torch.equal(a, b) for a, b in zip(graphed, eager))


# torch.distributed on the card: chip_smoke's sharded phases at small
# sizes, each on a NCCL group of one rank that the check starts and
# destroys (the machine has one card; the multi-rank exchanges are held
# against the reference on the CPU, tests/test_torch_{parallel,halo,dp_train}.py).


def test_card_sharded_dense_path(cuda_device):
    """chip_smoke ``sharded``: knn_sharded, chamfer_distance_sharded and
    denoise_sharded on one NCCL rank against the single-device functions."""
    import chip_smoke as cs

    rec = cs.check_sharded(n=4096)
    assert rec["denoise"]["collectives"]["all_gather"] >= 1


def test_card_fused_sharded_and_halo(cuda_device):
    """chip_smoke ``fused_sharded`` and ``halo``: the windowed engines on
    one NCCL rank, a cloud that is not a multiple of the tile."""
    import chip_smoke as cs

    sharded, halo = cs.check_fused_sharded_and_halo(n=20_000)
    assert sharded["collectives"]["all_gather"] >= 1
    assert halo["collectives"]["all_gather"] == 0


def test_card_fused_halo_on_one_rank_sends_nothing(cuda_device):
    """chip_smoke ``halo``: with one rank the halos are zeros and no point
    to point call is made."""
    import chip_smoke as cs

    _, halo = cs.check_fused_sharded_and_halo(n=8192)
    assert halo["collectives"]["send"] == halo["collectives"]["recv"] == 0


def test_card_dp_train(cuda_device, monkeypatch):
    """chip_smoke ``dp_train`` at a narrow width and on icosphere(3): the
    steps with a group of one against the steps without, TF32 refused, the
    fits, the sharded patch inference."""
    import chip_smoke as cs
    from ngpd_tpu_torch.config import ModelConfig

    monkeypatch.setattr(cs, "TRAIN_REF_P2N_CFG",
                        ModelConfig(hidden=(16, 16, 32, 32, 32, 32, 64, 32, 16)))
    monkeypatch.setattr(cs, "TRAIN_REF_EMB", 64)
    rec = cs.check_dp_train(mesh_subdiv=3)
    assert rec["fit"]["steps"] == cs.DP_FIT_STEPS and rec["faces"]["ok"]


def test_card_time_fn_synchronises_a_cuda_result(cuda_device):
    """``utils.time_fn`` waits for the card when the result (nested in a
    tuple, a dict and a list) holds a CUDA tensor."""
    from ngpd_tpu_torch.utils import time_fn

    a = torch.randn(2048, 2048, device=cuda_device)
    calls = []

    def fn():
        calls.append(1)
        return a, {"out": [a @ a @ a]}

    best = time_fn(fn, repeats=3, warmup=1)
    assert isinstance(best, float) and best > 0.0 and len(calls) == 4
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    # Host time of a synchronised call covers the card's time of the work.
    assert best * 1e3 >= 0.5 * t0.elapsed_time(t1)


def test_card_span_times_its_stream_and_adds_no_kernel(cuda_device):
    """A span on the card records its CUDA event pair around the stage's
    kernels; its annotation on the card's track is no kernel."""
    from torch.profiler import ProfilerActivity, profile

    from ngpd_tpu_torch.utils import prof

    a = torch.randn(4096, 4096, device=cuda_device)
    with prof.span("ngpd.test.off", cuda_device):  # nothing records: starts afresh
        pass

    def work(spans):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            if spans:
                with prof.span("ngpd.test.root", cuda_device):
                    with prof.span("ngpd.test.mm", cuda_device):
                        b = a @ a @ a
            else:
                b = a @ a @ a
            torch.cuda.synchronize()
        return p, b

    work(False)
    p0, _ = work(False)
    p1, _ = work(True)
    kernels = [[e for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation] for p in (p0, p1)]
    assert len(kernels[0]) == len(kernels[1]) > 0
    busy = sum(e.time_range.end - e.time_range.start for e in kernels[1]) / 1e3
    spans = prof.recorded()["spans"]
    assert spans["ngpd.test.mm"]["count"] == 1 and spans["ngpd.test.root"]["count"] == 1
    assert spans["ngpd.test.mm"]["stream_ms"] >= 0.9 * busy
    assert spans["ngpd.test.root"]["stream_ms"] >= spans["ngpd.test.mm"]["stream_ms"]
    assert spans["ngpd.test.root"]["host_ms"] >= spans["ngpd.test.mm"]["host_ms"]


def test_card_plot_cloud_takes_cuda_tensors(cuda_device, tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib.image as mpimg

    from ngpd_tpu_torch.apps import viz

    g = torch.Generator().manual_seed(0)
    pts = torch.randn(300, 3, generator=g)
    nrm = torch.nn.functional.normalize(torch.randn(300, 3, generator=g), dim=1)
    cls = torch.randint(0, 3, (300,), generator=g)
    got = viz.plot_cloud(pts.to(cuda_device), normals=nrm.to(cuda_device),
                         out=tmp_path / "card.png")
    want = viz.plot_cloud(pts.numpy(), normals=nrm.numpy(), out=tmp_path / "host.png")
    assert np.array_equal(mpimg.imread(got), mpimg.imread(want))
    assert viz.plot_classes(pts.to(cuda_device), cls.to(cuda_device),
                            out=tmp_path / "cls.png").stat().st_size > 1000


def test_card_knn_against_the_native_oracle(cuda_device):
    """chip_smoke ``native``'s kNN check at 20,000 points: ``knn`` and
    ``knn_grid`` on the card against ``native_grid_knn`` on the host."""
    import chip_smoke as cs

    rec = cs.check_native_knn(n=20_000)
    for name in ("knn", "knn_grid"):
        assert rec[name]["wrong_clear_indices"] == 0
        assert rec[name]["max_err_over_bound"] <= 1.0


# The kNN kernel (kernels/csrc/knn.cu): ``knn`` and ``nn_distances`` on
# CUDA tensors launch it once a call, for every k, and it returns the
# plain tile loop's bits.
def test_card_knn_kernel_matches_plain_on_the_smoke_cases(cuda_device):
    """chip_smoke ``knn_kernel``'s cases at a smaller size: the point
    track's cloud (plain, exclude_self, num_valid n - 50), mesh centroids
    at k 64, k 1 through nn_distances (the Chamfer gate's subsample and the
    whole cloud), the dense route's k 6, 8 and 16 and k 24, an integer
    lattice, separate queries, k past the valid count and past the
    register variants; each torch.equal to knn_plain on the card, one
    launch a call."""
    import chip_smoke as cs

    rec = cs.check_knn_kernel(cases=cs.knn_kernel_cases(
        n=20_000, mesh_subdiv=4, nn_points=100_000, nn_queries=4_000, lattice_side=20,
        dense_n=8_192))
    assert all(r["equal"] and r["launches"] == 1 for r in rec["cases"])
    assert all(r["merge_launches"] == int(r["slices"] > 1) for r in rec["cases"])
    assert rec["timed"]["ms"] > 0 and rec["timed"]["bound_by"] in ("bytes", "operations")
    assert len(rec["build"]) == 4 and all(b["registers"] > 0 for b in rec["build"].values())
    assert rec["merge"]["slices"] > 1 and rec["merge"]["ms"] > 0
    assert rec["merge"]["case"] == "dense_k8" and rec["merge_split"]["slices"] > 1


@pytest.mark.parametrize("k", [1, 2, 6, 8, 9, 12, 16, 17, 32, 33, 64, 65, 130, 300, 1000])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_card_knn_kernel_every_variant(cuda_device, k, exclude_self):
    """Every variant (a register list of 1, 8 or 16 keys, a row in device
    memory past 16, up to k 1000) at and past its size, on a cloud that
    holds duplicated points, with num_valid: one launch, the plain loop's
    bits."""
    from ngpd_tpu_torch.kernels import knn as kknn
    from ngpd_tpu_torch.ops.knn import knn, knn_plain

    pts = torch.as_tensor(make_cloud(5_000)[0]).to(cuda_device)
    kknn.reset_launch_counts()
    got, gd = knn(pts, k, exclude_self=exclude_self, num_valid=4_900)
    assert kknn.LAUNCHES["knn"] == 1
    want, wd = knn_plain(pts, k, exclude_self=exclude_self, num_valid=4_900)
    assert torch.equal(gd, wd) and torch.equal(got.idx, want.idx)
    assert torch.equal(got.mask, want.mask)
    assert got.idx.dtype == torch.int64 and gd.device.type == "cuda"


def test_card_knn_never_runs_the_plain_loop(cuda_device, monkeypatch):
    """On CUDA tensors ``knn`` and ``nn_distances`` go to the kernel alone,
    one launch each, queries of another cloud and k past the valid count
    included."""
    from ngpd_tpu_torch.kernels import knn as kknn
    from ngpd_tpu_torch.ops import knn as ops_knn

    pts = torch.as_tensor(make_cloud(4_096)[0]).to(cuda_device)
    q = pts[::3] + 0.001
    want = [ops_knn.knn_plain(pts, 16, q, num_valid=9), ops_knn.knn_plain(pts, 1, q)]
    monkeypatch.setattr(ops_knn, "knn_plain", lambda *a, **k: pytest.fail("ran the loop"))
    kknn.reset_launch_counts()
    nbh, d = ops_knn.knn(pts, 16, q, num_valid=9)
    assert kknn.LAUNCHES["knn"] == 1
    assert torch.equal(d, want[0][1]) and torch.equal(nbh.idx, want[0][0].idx)
    assert not nbh.mask[:, 9:].any()
    nd, ni = ops_knn.nn_distances(q, pts)
    assert kknn.LAUNCHES["knn"] == 2
    assert torch.equal(nd, want[1][1][:, 0]) and torch.equal(ni, want[1][0].idx[:, 0])


def test_card_knn_split_path(cuda_device):
    """Few queries against many points split the points into slices: one
    launch of the search kernel and one of the merge, the plain loop's
    bits; the merge kernel alone equals merge_plain on the partial rows."""
    from ngpd_tpu_torch.kernels import knn as kknn
    from ngpd_tpu_torch.ops.knn import knn, knn_plain

    noisy, _, clean = make_cloud(200_000)
    pts = torch.as_tensor(noisy).to(cuda_device)
    q = torch.as_tensor(clean[::400]).to(cuda_device)
    for k in (1, 16, 64):
        assert kknn.slices(len(q), len(pts), k) > 1
        kknn.reset_launch_counts()
        got, gd = knn(pts, k, q, num_valid=199_000)
        assert kknn.LAUNCHES == {"knn": 1, "knn_merge": 1, "knn_boxes": 0, "knn_caps": 1}
        want, wd = knn_plain(pts, k, q, num_valid=199_000)
        assert torch.equal(gd, wd) and torch.equal(got.idx, want.idx)
    s = kknn.slices(len(q), len(pts), 16)
    part = kknn.split(pts, q, 16, len(pts), False, s)
    d = torch.empty((len(q), 16), device=cuda_device)
    idx = torch.empty((len(q), 16), dtype=torch.int64, device=cuda_device)
    kknn._launch("knn_merge", "knn_merge", part.data_ptr(), d.data_ptr(), idx.data_ptr(),
                 len(q), 16, s)
    pd, pidx = kknn.merge_plain(part)
    assert torch.equal(d, pd) and torch.equal(idx, pidx)


@pytest.mark.parametrize("k,exclude_self", [(64, False), (128, False), (128, True)])
def test_card_knn_roof_past_the_register_lists(cuda_device, k, exclude_self):
    """The point track's cloud at md_selection's k 64 and at k 128, whose
    lists are rows in device memory fed through the buffers: the plain
    loop's bits."""
    from ngpd_tpu_torch.ops.knn import knn, knn_plain

    pts = torch.as_tensor(make_cloud(100_000 if k == 64 else 30_000)[0]).to(cuda_device)
    got, gd = knn(pts, k, exclude_self=exclude_self)
    want, wd = knn_plain(pts, k, exclude_self=exclude_self)
    assert torch.equal(gd, wd) and torch.equal(got.idx, want.idx)
    assert torch.equal(got.mask, want.mask)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_card_knn_sweeps_every_k_of_the_row_lists(cuda_device, exclude_self):
    """Every k from 17 to 128 (rows in device memory fed through the
    buffers) on a uniform cloud in random index order, where the home tile
    caps little: each query fills its buffer many times (checked at k 17,
    the fewest), so every k runs many merges. The plain loop's bits at
    each k."""
    from ngpd_tpu_torch.kernels import knn as kknn
    from ngpd_tpu_torch.ops.knn import knn, knn_plain, pairwise_sqdist

    rng = np.random.default_rng(7)
    pts = torch.as_tensor(rng.random((16_384, 3)).astype(np.float32)).to(cuda_device)
    # The first 256 queries' home tile is points [0, TILE): a query takes
    # every candidate at or below the k-th distance there.
    d = pairwise_sqdist(pts[:256], pts)
    if exclude_self:
        d[torch.arange(256), torch.arange(256)] = float("inf")
    cap = torch.kthvalue(d[:, : kknn.TILE], 17, dim=1).values
    assert (d <= cap[:, None]).sum(1).median() >= 4 * kknn.BUF
    for k in range(17, 129):
        got, gd = knn(pts, k, exclude_self=exclude_self)
        want, wd = knn_plain(pts, k, exclude_self=exclude_self)
        assert torch.equal(gd, wd) and torch.equal(got.idx, want.idx), k


# The graph kernels (kernels/csrc/feature_knn.cu, edge_block.cu): the DGCNN's
# feature kNN and both models' edge blocks launch them on CUDA tensors and
# return their plain versions' bits.
def _int_features(b, p, c, seed=0, equal_rows=24):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 3, (b, p, c), generator=g).float()
    x[:, max(1, p - equal_rows):] = 0.0
    return x


@pytest.mark.parametrize("b,p,c,k", [(1, 64, 17, 8), (256, 64, 17, 1), (256, 64, 64, 16),
                                     (2048, 64, 128, 8), (2048, 64, 256, 8), (1, 64, 256, 16),
                                     (97, 37, 100, 5), (3, 200, 40, 12), (5, 16, 907, 16)])
def test_card_feature_knn_matches_plain(cuda_device, b, p, c, k):
    """Small-integer features with repeated rows (every distance exact, ties
    everywhere): one launch, ``torch.equal`` to ``feature_knn_plain`` on the
    card. C 256 and 907 take the shared-memory opt-in (64 KB and 58 KB a
    patch), C 17 and 907 a width that is no multiple of 4, P 37 and 200 a
    patch that is no multiple of 16, B 1 one block."""
    from ngpd_tpu_torch.kernels import graph
    from ngpd_tpu_torch.models import dgcnn

    x = _int_features(b, p, c).to(cuda_device)
    graph.reset_launch_counts()
    got = dgcnn.feature_knn(x, k)
    assert graph.LAUNCHES["feature_knn"] == 1
    assert got.dtype == torch.int64 and got.shape == (b, p, k)
    assert torch.equal(got, dgcnn.feature_knn_plain(x, k))


def test_card_feature_knn_refuses_past_its_limits(cuda_device):
    """P past 256, k past 16 and another type are refused; C sets no limit
    (the patch streams through shared memory in slabs), so C 1024 runs."""
    from ngpd_tpu_torch.models import dgcnn

    x = _int_features(2, 64, 1024).to(cuda_device)
    assert torch.equal(dgcnn.feature_knn(x, 8), dgcnn.feature_knn_plain(x, 8))
    with pytest.raises(ValueError, match="FEATURE_KNN_MAX_P"):
        dgcnn.feature_knn(torch.zeros((1, 257, 4), device=cuda_device), 8)
    with pytest.raises(ValueError, match="FEATURE_KNN_MAX_K"):
        dgcnn.feature_knn(x[:, :, :8].contiguous(), 17)
    with pytest.raises(TypeError):
        dgcnn.feature_knn(x.double(), 8)


@pytest.mark.parametrize("order", ["dgcnn", "edgeconv"])
@pytest.mark.parametrize("b,c,k", [(1, 17, 3), (2048, 17, 3), (2048, 64, 3), (2048, 128, 8),
                                   (2048, 256, 8), (1024, 8, 12), (1024, 256, 12), (7, 6, 5)])
def test_card_edge_block_matches_plain(cuda_device, order, b, c, k):
    """Every width and K of both forwards, both orders, one launch,
    ``torch.equal`` to ``edge_block_plain``; C 17 and 6 take the float
    path, and so does x starting one float past 16 bytes."""
    from ngpd_tpu_torch.kernels import graph
    from ngpd_tpu_torch.models import edge

    g = torch.Generator().manual_seed(c * 100 + k)
    x = torch.randn((b, 64, c), generator=g).to(cuda_device)
    idx = torch.randint(0, 64, (b, 64, k), generator=g).to(cuda_device)
    graph.reset_launch_counts()
    got = edge.edge_block(x, idx, order)
    assert graph.LAUNCHES["edge_block"] == 1
    assert torch.equal(got, edge.edge_block_plain(x, idx, order))
    shifted = torch.randn((b * 64 * c + 1,), generator=g).to(cuda_device)[1:].view(b, 64, c)
    assert torch.equal(edge.edge_block(shifted, idx, order),
                       edge.edge_block_plain(shifted, idx, order))


def test_card_edge_block_gradient_matches_plain(cuda_device):
    """The edge block's backward on the card against autograd of the plain
    expression on the card: the same operations on the same terms (held to
    1e-6 of the largest, in case the card's accumulation order varies)."""
    from ngpd_tpu_torch.models import edge

    g = torch.Generator().manual_seed(3)
    x = torch.randn((64, 64, 32), generator=g).to(cuda_device)
    idx = torch.randint(0, 64, (64, 64, 8), generator=g).to(cuda_device)
    w = torch.randn((64, 64, 8, 64), generator=g).to(cuda_device)
    for order in ("dgcnn", "edgeconv"):
        a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
        (edge.edge_block(a, idx, order) * w).sum().backward()
        (edge.edge_block_plain(b, idx, order) * w).sum().backward()
        scale = float(b.grad.abs().max())
        assert float((a.grad - b.grad).abs().max()) <= 1e-6 * scale


def test_card_graph_kernels_carry_both_models(cuda_device, monkeypatch):
    """A DGCNN forward launches the feature kNN three times, the edge block
    six times and the epilogue seven times, a Patch2Normal forward the edge
    block six times; the plain versions are never called."""
    from ngpd_tpu_torch.kernels import graph
    from ngpd_tpu_torch.models import dgcnn, edge
    from ngpd_tpu_torch.models.patch2normal import init_patch2normal

    monkeypatch.setattr(dgcnn, "feature_knn_plain", lambda *a: pytest.fail("plain kNN"))
    monkeypatch.setattr(edge, "edge_block_plain", lambda *a: pytest.fail("plain block"))
    monkeypatch.setattr(dgcnn, "dgcnn_epilogue_plain", lambda *a: pytest.fail("plain epilogue"))
    g = torch.Generator().manual_seed(0)
    inputs = torch.cat([torch.randn((16, 17, 64), generator=g),
                        torch.randint(0, 64, (16, 3, 64), generator=g).float()], dim=1)
    graph.reset_launch_counts()
    with torch.no_grad():
        out = dgcnn.DGCNN().eval().to(cuda_device)(inputs.to(cuda_device))
    assert graph.LAUNCHES == {"feature_knn": 3, "edge_block": 6, "dgcnn_epilogue": 7}
    assert torch.isfinite(out).all()
    model = init_patch2normal(seed=0).to(cuda_device)
    x = torch.randn((8, 64, 8), generator=g).to(cuda_device)
    nbr = torch.randint(0, 64, (8, 64, 12), generator=g).to(cuda_device)
    graph.reset_launch_counts()
    with torch.no_grad():
        model(x, nbr, torch.ones((8, 64, 12), dtype=torch.bool, device=cuda_device),
              torch.ones((8, 64), dtype=torch.bool, device=cuda_device))
    assert graph.LAUNCHES == {"feature_knn": 0, "edge_block": 6, "dgcnn_epilogue": 0}


def test_card_dgcnn_kernels_smoke_check(cuda_device):
    """chip_smoke ``dgcnn_kernels`` at a smaller size: integer features and
    the mesh cell's activations (icosphere(4), 512 patches), every edge
    shape at batch 256 and 128."""
    import chip_smoke as cs

    rec = cs.check_dgcnn_kernels(mesh_subdiv=4, mesh_batch=512, point_batch=128)
    assert all(r.get("equal", True) and not r.get("differing_clear_rows", 0)
               for r in rec["feature_knn"])
    assert all(r["equal"] and r["ms"] > 0 for r in rec["edge_block"])
    assert rec["feature_knn"][-1]["build"]["registers"] > 0
    assert [(r["k"], r["c"]) for r in rec["dgcnn_epilogue"]] == [
        (3, 64), (3, 64), (3, 128), (8, 256), (8, 256), (8, 256), (1, 1024)]
    assert all(r["equal"] and r["specials_equal"] and r["ms"] > 0
               for r in rec["dgcnn_epilogue"])


# (K, C, misaligned): the model's shapes (float4 kernels at K 1, 3 and 8),
# a K read at run time, a width that is no multiple of 4 and an h that
# does not lie on 16 bytes (the one-channel kernels).
EPILOGUE_CASES = [(3, 64, False), (8, 256, False), (1, 1024, False), (5, 128, False),
                  (16, 64, False), (3, 18, False), (8, 64, True)]


@pytest.mark.parametrize("k,c,misaligned", EPILOGUE_CASES,
                         ids=[f"k{k}_c{c}{'_misaligned' if m else ''}"
                              for k, c, m in EPILOGUE_CASES])
def test_card_dgcnn_epilogue_equals_its_plain_version(cuda_device, k, c, misaligned):
    """Every bit of the kernel's output is the plain version's, the sign of
    a zero included: on products around the BatchNorm terms with NaN and
    infinities planted (NaN at the same places), and on products whose
    maxima tie +0 against -0 (the order of torch.amax's accumulators)."""
    from ngpd_tpu_torch.kernels import graph
    from ngpd_tpu_torch.models import dgcnn

    g = torch.Generator().manual_seed(k * 1000 + c)
    shape = (37, 64, k, c) if k > 1 else (37, 64, c)
    n = int(np.prod(shape))
    buf = torch.empty(n + 1, device=cuda_device)
    h = buf[1:] if misaligned else buf[:n]
    h = h.view(shape)
    h.copy_(torch.randn(shape, generator=g) * 3.0)
    mean, mul, bias = (torch.randn((c,), generator=g).to(cuda_device) for _ in range(3))
    flat = h.view(-1)
    flat[torch.randint(0, n, (50,), generator=g)] = float("nan")
    flat[torch.randint(0, n, (50,), generator=g)] = float("inf")
    flat[torch.randint(0, n, (50,), generator=g)] = float("-inf")
    graph.reset_launch_counts()
    got = dgcnn.dgcnn_epilogue(h, mean, mul, bias, k)
    want = dgcnn.dgcnn_epilogue_plain(h, mean, mul, bias, k)
    assert graph.LAUNCHES["dgcnn_epilogue"] == 1
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and nan.any()
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))
    # Zeros of both signs and -1 (slope -0.2): the maximum is a zero, and
    # which one torch.amax keeps shows in the sign.
    z = torch.tensor([0.0, -0.0, -1.0])[torch.randint(0, 3, (n,), generator=g)]
    h.copy_(z.view(shape))
    # x - 0, * 1 and + (-0) keep a zero's sign.
    zero, one = torch.zeros((c,), device=cuda_device), torch.ones((c,), device=cuda_device)
    got = dgcnn.dgcnn_epilogue(h, zero, one, -zero, k)
    want = dgcnn.dgcnn_epilogue_plain(h, zero, one, -zero, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_card_dgcnn_forward_takes_the_epilogue_only_without_a_gradient(cuda_device):
    """An eval forward under no_grad equals the plain route bit for bit; a
    train-mode forward and an eval forward that takes a gradient launch no
    epilogue."""
    from ngpd_tpu_torch.kernels import graph
    from ngpd_tpu_torch.models import dgcnn

    g = torch.Generator().manual_seed(1)
    inputs = torch.cat([torch.randn((64, 17, 64), generator=g),
                        torch.randint(0, 64, (64, 3, 64), generator=g).float()],
                       dim=1).to(cuda_device)
    model = dgcnn.DGCNN(dropout=0.0).to(cuda_device).eval()
    gc = torch.Generator(cuda_device).manual_seed(2)
    for i in range(1, 8):
        bn = getattr(model, f"bn{i}")
        bn.running_mean.normal_(generator=gc)
        bn.running_var.uniform_(0.5, 2.0, generator=gc)
    graph.reset_launch_counts()
    with torch.no_grad():
        got = model(inputs)
    assert graph.LAUNCHES["dgcnn_epilogue"] == 7
    kernel = dgcnn.dgcnn_epilogue
    try:
        dgcnn.dgcnn_epilogue = dgcnn.dgcnn_epilogue_plain
        with torch.no_grad():
            want = model(inputs)
    finally:
        dgcnn.dgcnn_epilogue = kernel
    assert torch.equal(got, want)
    graph.reset_launch_counts()
    model(inputs).sum().backward()
    model.train()(inputs)
    assert graph.LAUNCHES["dgcnn_epilogue"] == 0
