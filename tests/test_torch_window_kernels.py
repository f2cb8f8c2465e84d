"""Window kernels K0/K1/K2 of the port against the JAX Pallas kernels.

The plain PyTorch versions (``ngpd_tpu_torch/kernels/window.py``, what
the wrappers run on CPU tensors) are held against
``ngpd_tpu/core/pallas_fused.py``'s ``_make_k0/_make_k1/_make_k2`` run
through ``pl.pallas_call(..., interpret=True)`` with the grid spec of
``pallas_denoise_hybrid``, on the same Morton-sorted pack. Every K2
strategy variant (the use_flat/use_edge/use_new flags and 0-3 lagged
classes) and ``sub`` 1 and 2 are covered. The CUDA kernels themselves are
held against these plain versions on the card in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ngpd_tpu.config import DenoiseConfig as JaxConfig
from ngpd_tpu.core import pallas_fused as pf
from ngpd_tpu_torch.config import DenoiseConfig
from ngpd_tpu_torch.core import hybrid_stages as hs
from ngpd_tpu_torch.core.cuda_fused import padded_size
from ngpd_tpu_torch.kernels import window as kw
from ngpd_tpu_torch.ops.morton import morton_sort

from fixtures import cube_corner

torch.set_num_threads(2)

TILE, WINDOW = 128, 128
K2_STRATEGIES = [
    ("flat", "edge", "feature"),
    ("new", "corner", "feature"),
    ("dummy", "edge", "corner"),
    ("flat", "new", "flat"),
    ("new", "flat", "edge"),
    ("corner", "feature", "dummy"),
]


def _cloud():
    pts, nrm, _ = cube_corner(18, spacing=0.05)
    rng = np.random.default_rng(0)
    noisy = (pts + rng.normal(scale=0.005, size=pts.shape)).astype(np.float32)
    return noisy, nrm


def _sorted_pack(sub):
    """The Morton-sorted slim pack both sides read, plus its geometry."""
    noisy, nrm = _cloud()
    n_in = len(noisy)
    n, sub = padded_size(n_in, TILE, WINDOW, sub)
    pts = torch.zeros((n, 3))
    nr = torch.zeros((n, 3))
    pts[:n_in] = torch.as_tensor(noisy)
    nr[:n_in] = torch.as_tensor(nrm)
    sc = morton_sort(pts, nr, n_in)
    pack = hs.build_pack_slim(sc.pos.T.contiguous(), sc.nrm.T.contiguous())
    return pack, kw.make_windows(n, n_in, TILE, WINDOW, sub, "cpu"), sub


def _run_jax(make_kernel, sub, win, rows, pack, scal=None):
    """Run ``make_kernel(wt, num_tiles)`` through pl.pallas_call in
    interpret mode with the grid spec of pallas_denoise_hybrid."""
    import jax

    n = win.n
    dma = TILE * sub
    wt = min(dma + 2 * WINDOW, n)
    wt_c = wt - (sub - 1) * TILE
    num_tiles = n // dma
    starts = jnp.clip(jnp.arange(num_tiles, dtype=jnp.int32) * dma - WINDOW, 0, n - wt)
    sub_starts = jnp.clip(
        jnp.arange(num_tiles * sub, dtype=jnp.int32) * TILE - WINDOW, 0, n - wt_c
    )
    assert np.array_equal(np.asarray(sub_starts), win.starts.numpy())
    assert wt_c == win.wt_c
    in_specs = [pl.BlockSpec(memory_space=pl.ANY)] * 2
    args = [starts, sub_starts, jnp.asarray([win.nv], jnp.int32)]
    args += [jnp.asarray(pack.numpy())] * 2
    if scal is not None:
        in_specs.append(pl.BlockSpec((8, 128), lambda t, *_: (0, 0)))
        args.append(jnp.asarray(scal.numpy()))
    call = pl.pallas_call(
        make_kernel(wt, num_tiles),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=3,
            grid=(num_tiles,),
            in_specs=in_specs,
            out_specs=pl.BlockSpec((rows, dma), lambda t, *_: (0, t)),
            scratch_shapes=[
                pltpu.VMEM((2, 8, dma), jnp.float32),
                pltpu.VMEM((2, 8, wt), jnp.float32),
                pltpu.SemaphoreType.DMA((2, 2)),
            ],
        ),
        out_shape=jax.ShapeDtypeStruct((rows, n), jnp.float32),
        interpret=True,
    )
    return torch.from_numpy(np.asarray(call(*args)))


def _k0_both(sub, cfg):
    pack, win, sub = _sorted_pack(sub)
    jcfg = JaxConfig(feature_k=cfg.feature_k, step_k=cfg.step_k)
    want = _run_jax(
        lambda wt, nt: pf._make_k0(TILE, wt, nt, jcfg, sub=sub), sub, win, 8, pack
    )
    return pack, win, sub, want, kw.k0(pack, win, cfg.feature_k, cfg.step_k)


@pytest.mark.parametrize("sub", [1, 2])
def test_k0_plain_matches_pallas(sub):
    """The reference's CPU contraction rounds some distances an ulp
    apart from the port's fixed order, which can move a bisection by its
    last steps: the thresholds agree to two of its final steps
    (2 * dmax * 2^-24, dmax <= 7 on this cloud, so 8e-7) and the 6-NN
    counts exactly. The edge sums include the self-distance, zero up to
    the cancellation noise of |q|^2 + |q|^2 - 2 q.q (eps * 2|p|^2 <= 3e-7
    on this cloud), whose sqrt (<= 6e-4) each side rounds its own way,
    hence atol 1e-3."""
    _, _, _, want, got = _k0_both(sub, DenoiseConfig(feature_k=16, step_k=8))
    torch.testing.assert_close(got[0:2], want[0:2], rtol=0.0, atol=8e-7)
    assert torch.equal(got[3:], want[3:])
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=1e-3)


def _k1_inputs(sub):
    cfg = DenoiseConfig()
    pack, win, sub, want0, got0 = _k0_both(sub, cfg)
    pack = hs.set_rk_slim(pack, want0[0] * 1.05, want0[1] * 1.05)
    return cfg, pack, win, sub


@pytest.mark.parametrize("sub", [1, 2])
def test_k1_plain_matches_pallas(sub):
    """Same masks, sums in another order: t6 entries (at most 1 in size)
    to 1e-6."""
    cfg, pack, win, sub = _k1_inputs(sub)
    want = _run_jax(
        lambda wt, nt: pf._make_k1(TILE, wt, nt, JaxConfig(), sub=sub),
        sub, win, 8, pack,
    )
    got = kw.k1(pack, win, cfg.angle)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _scal():
    """A lag state with distinct deltas and centres in every slot."""
    scal = torch.zeros((8, 128))
    scal[0, 0] = 0.01
    scal[1, 0], scal[2, 0], scal[3, 0] = 0.3, 0.2, 0.25
    scal[4, 0:3] = torch.tensor([0.5, 0.4, 0.3])
    scal[5, 0:3] = torch.tensor([0.1, 0.2, 0.3])
    scal[6, 0:3] = torch.tensor([0.0, 0.9, 0.3])
    return scal


@pytest.mark.parametrize("sub", [1, 2])
@pytest.mark.parametrize("strategy", K2_STRATEGIES, ids="-".join)
def test_k2_plain_matches_pallas(strategy, sub):
    """Every row of K2's layout. Masks agree exactly; the weighted sums
    run in another order, so each row agrees to 1e-5 of its largest
    value (the Q rows reach ~10 in size)."""
    cfg, pack, win, sub = _k1_inputs(sub)
    t6 = kw.k1(pack, win, cfg.angle)
    pack2 = hs.vu_stage(t6, pack, cfg)
    needs_delta = hs.needs_delta_of(strategy)
    lay = kw.k2_layout(strategy, needs_delta)
    scal = _scal()
    want = _run_jax(
        lambda wt, nt: pf._make_k2(TILE, wt, nt, JaxConfig(), strategy,
                                   needs_delta, sub=sub),
        sub, win, lay["_total"], pack2, scal,
    )
    got = kw.k2(pack2, scal, win, cfg.angle, strategy, len(needs_delta))
    assert got.shape == want.shape
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    assert float(((got - want).abs() / scale).max()) < 1e-5


def test_k2_layout_matches_reference():
    for strategy in K2_STRATEGIES:
        nd = hs.needs_delta_of(strategy)
        assert nd == tuple(c for c in range(3) if strategy[c] in ("flat", "new"))
        assert kw.k2_layout(strategy, nd) == pf._k2_layout(strategy, nd)


def test_windows_match_reference_geometry():
    """Padding, sub fallback and window starts as pallas_fused.py:1527-1549."""
    for n_in, tile, window, sub in [(919, 128, 128, 2), (919, 128, 128, 8),
                                    (5000, 256, 128, 8), (100_000, 256, 512, 8)]:
        dma = tile * sub
        n = -(-n_in // dma) * dma
        s = sub
        if n < dma + 2 * window and sub > 1:
            s, dma = 1, tile
            n = -(-n_in // dma) * dma
        assert padded_size(n_in, tile, window, sub) == (n, s)
        wt = min(dma + 2 * window, n)
        wt_c = wt - (s - 1) * tile
        want = np.clip(np.arange(n // tile) * tile - window, 0, n - wt_c)
        win = kw.make_windows(n, n_in, tile, window, s, "cpu")
        assert win.wt_c == wt_c
        assert np.array_equal(win.starts.numpy(), want)
