"""The port on the card: each CUDA kernel against its plain version, and
the card's denoise against the CPU path. Imports neither JAX nor
ngpd_tpu, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Without a card every test skips (the CUDA kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from ngpd_tpu_torch.bench import make_cloud
from ngpd_tpu_torch.config import DenoiseConfig
from ngpd_tpu_torch.core import hybrid_stages as hs
from ngpd_tpu_torch.core.cuda_fused import denoise_hybrid, prologue
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


@pytest.mark.parametrize("window", [128, 512])
@pytest.mark.parametrize("strategy", STRATEGIES, ids="-".join)
def test_kernels_match_plain(cuda_device, strategy, window):
    """Thresholds and counts are computed in the same order with the same
    rounding on both sides, so K0's rows other than the edge sums match
    exactly; sums run in another order, so they agree to 1e-5 of each
    row's largest value."""
    noisy, nrm, _ = make_cloud(16_384)
    cfg = DenoiseConfig(feature_k=32, step_k=8)
    st = prologue(noisy, nrm, cfg, strategy, window=window, device=cuda_device)
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
    g, _, gc = denoise_hybrid(noisy, nrm, iterations=2, lagged_nvt1=lagged,
                              device=cuda_device)
    c, _, cc = denoise_hybrid(noisy, nrm, iterations=2, lagged_nvt1=lagged,
                              device="cpu")
    diff = (g.cpu() - c).abs().amax(dim=1).numpy()
    assert np.mean(gc.cpu().numpy() == cc.numpy()) >= 0.99
    assert np.mean(diff <= 2e-3) >= 0.999 and diff.max() <= 2e-2


def _flips(got, ref, tol, cols=None):
    """Share of columns (of ``cols``, or all) whose largest difference
    exceeds tol, and the largest difference."""
    diff = (got - ref).abs().amax(dim=0)
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


@pytest.mark.parametrize("n_in,num_valid", [(16_384, None), (16_000, 15_900)])
def test_card_passes_match_cpu(cuda_device, n_in, num_valid):
    """denoise_passes on the card against the CPU path, under the
    hybrid's mask-flip bound, on a cloud of whole tiles and on a padded
    one."""
    from ngpd_tpu_torch.core.cuda_fused import denoise_passes

    noisy, nrm, _ = make_cloud(16_384)
    noisy, nrm = noisy[:n_in], nrm[:n_in]
    g, _, gc = denoise_passes(noisy, nrm, iterations=2, num_valid=num_valid,
                              device=cuda_device)
    c, _, cc = denoise_passes(noisy, nrm, iterations=2, num_valid=num_valid,
                              device="cpu")
    diff = (g.cpu() - c).abs().amax(dim=1).numpy()
    assert np.mean(gc.cpu().numpy() == cc.numpy()) >= 0.99
    assert np.mean(diff <= 2e-3) >= 0.999 and diff.max() <= 2e-2
