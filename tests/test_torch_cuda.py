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
