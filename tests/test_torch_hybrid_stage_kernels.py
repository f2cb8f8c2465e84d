"""The hybrid engine's per-point stage wrappers (``kernels/hybrid.py``) on
the CPU: CPU tensors take the plain stages of ``core/hybrid_stages.py``
and launch nothing; CUDA operands reach the kernel launch, never the
plain stages, and operands the kernels cannot take raise. The kernels
themselves are held against the plain stages on the card in
test_torch_cuda.py."""

import pytest
import torch

from ngpd_tpu_torch.bench import make_corner_cloud
from ngpd_tpu_torch.config import DenoiseConfig
from ngpd_tpu_torch.core import hybrid_stages as hs
from ngpd_tpu_torch.core.cuda_fused import denoise_hybrid, prologue
from ngpd_tpu_torch.kernels import build
from ngpd_tpu_torch.kernels import hybrid as khy
from ngpd_tpu_torch.kernels import passes as kp
from ngpd_tpu_torch.kernels import window as kw

torch.set_num_threads(2)

STRATEGIES = [("flat", "edge", "feature"), ("new", "corner", "feature"),
              ("dummy", "edge", "corner"), ("flat", "new", "flat")]


def _stage_inputs(strategy, num_valid=None):
    """Prologue, K1, the VU stage and K2 of a tiled-corner cloud on the CPU:
    the operands of both stages."""
    noisy, nrm, _ = make_corner_cloud(4_096)
    cfg = DenoiseConfig(feature_k=16, step_k=8)
    st = prologue(noisy, nrm, cfg, strategy, num_valid=num_valid, tile=128, window=64,
                  sub=1, device="cpu")
    t6 = kw.k1(st.pack, st.win, cfg.angle)
    pack2 = hs.vu_stage(t6, st.pack, cfg)
    k2 = kw.k2(pack2, st.scal, st.win, cfg.angle, strategy, len(st.needs_delta))
    return cfg, st, t6, pack2, k2


@pytest.mark.parametrize("strategy", STRATEGIES, ids="-".join)
def test_cpu_tensors_take_the_plain_stages(strategy):
    """On CPU tensors both wrappers return the plain stages' results, bit
    for bit, and count no launch; K2's t6 rows are taken as they are
    (the lagged-NVT1 route)."""
    cfg, st, t6, pack2, k2 = _stage_inputs(strategy, num_valid=4_000)
    lay = st.lay
    khy.reset_launch_counts()
    assert torch.equal(khy.vu_stage(t6, st.pack, cfg), pack2)
    rows = k2[lay["t6"] : lay["t6"] + 6]
    assert torch.equal(khy.vu_stage(rows, st.pack, cfg), hs.vu_stage(rows, st.pack, cfg))
    got = khy.update_stage(k2, pack2, st.d_thr, cfg, strategy, st.needs_delta, lay, st.win.nv)
    want = hs.update_stage(k2, pack2, st.d_thr, cfg, strategy, st.needs_delta, lay,
                           st.win.nv)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert khy.LAUNCHES == {"hybrid_vu": 0, "hybrid_update": 0}


@pytest.mark.parametrize("lagged", [False, True])
def test_cpu_denoise_hybrid_launches_no_stage_kernel(lagged):
    noisy, nrm, _ = make_corner_cloud(2_048)
    khy.reset_launch_counts()
    out = denoise_hybrid(noisy, nrm, iterations=2, lagged_nvt1=lagged, device="cpu")
    assert all(bool(torch.isfinite(x.float()).all()) for x in out)
    assert khy.LAUNCHES == {"hybrid_vu": 0, "hybrid_update": 0}


def _block_parts(k2, cls, lay, needs_delta, nv):
    """The update kernel's partials as plain torch: per block of THREADS
    points and per delta class, the sums of jp and deg and the largest
    maxd over that class's points below nv."""
    n = cls.shape[0]
    blocks = -(-n // khy.THREADS)
    pad = blocks * khy.THREADS - n
    valid = torch.arange(n) < nv
    rows = []
    for ci, c in enumerate(needs_delta):
        mask = ((cls == float(c)) & valid).float()
        for v, op in [*((k2[lay["jp"] + r], "sum") for r in range(3)),
                      (k2[lay["deg"]], "sum"), (k2[lay["maxd"] + ci], "max")]:
            blk = torch.nn.functional.pad(v * mask, (0, pad)).view(blocks, -1)
            rows.append(blk.sum(dim=1) if op == "sum" else blk.amax(dim=1))
    return torch.stack(rows) if rows else torch.zeros((0, blocks))


@pytest.mark.parametrize("strategy", STRATEGIES, ids="-".join)
def test_block_partials_reduce_to_the_stage_lag_state(strategy):
    """The update kernel's partials, reduced by ``passes.lag_scal``, give
    the lag state of ``update_stage``: the deltas exactly (a maximum in
    any order), the centres within 1e-6 of the cloud's extent (the sums
    run per block, then over the blocks)."""
    cfg, st, _, pack2, k2 = _stage_inputs(strategy, num_valid=4_000)
    _, scal, cls = hs.update_stage(k2, pack2, st.d_thr, cfg, strategy, st.needs_delta,
                                   st.lay, st.win.nv)
    parts = _block_parts(k2, cls, st.lay, st.needs_delta, st.win.nv)
    assert parts.shape == (5 * len(st.needs_delta), -(-st.win.n // khy.THREADS))
    got = kp.lag_scal(st.d_thr, parts)
    nd = len(st.needs_delta)
    assert torch.equal(got[0:4, 0], scal[0:4, 0])
    assert torch.equal(got[:, 3:], scal[:, 3:]) and torch.equal(got[0:4, 1:], scal[0:4, 1:])
    extent = float(pack2[0:3].abs().max())
    torch.testing.assert_close(got[4 : 4 + nd], scal[4 : 4 + nd], rtol=0, atol=1e-6 * extent)


def test_cuda_operands_reach_the_launch_not_the_plain_stages(monkeypatch):
    """Operands that pass as CUDA go to the kernel build and launch: with no
    nvcc that raises, the plain stages are never called and no launch is
    counted."""
    try:
        build.find_nvcc()
        pytest.skip("nvcc is present; the missing-compiler path cannot be observed")
    except RuntimeError:
        pass
    cfg, st, t6, pack2, k2 = _stage_inputs(("flat", "edge", "feature"))
    monkeypatch.setattr(khy, "_on_cuda", lambda **kw_: True)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(hs, "vu_stage", lambda *a: pytest.fail("ran the plain VU stage"))
    monkeypatch.setattr(hs, "update_stage", lambda *a: pytest.fail("ran the plain update"))
    before = dict(khy.LAUNCHES)
    strategy = ("flat", "edge", "feature")
    for call in (lambda: khy.vu_stage(t6, st.pack, cfg),
                 lambda: khy.update_stage(k2, pack2, st.d_thr, cfg, strategy,
                                          st.needs_delta, st.lay, st.win.nv)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert khy.LAUNCHES == before


def test_update_launch_carries_the_layout_and_the_strategy(monkeypatch):
    """The launch gets K2's row offsets in the launch function's order
    (-1 for groups the strategy leaves out), the step kinds and sizes as
    the pass kernels take them, the delta classes, and partials of one
    column a block of THREADS points, which lag_scal reduces."""
    strategy = ("new", "corner", "feature")
    cfg, st, _, pack2, k2 = _stage_inputs(strategy)
    seen = {}

    def launch(name, counts, *args):
        seen[name] = args
        counts[name] += 1

    monkeypatch.setattr(khy, "_on_cuda", lambda **kw_: True)
    monkeypatch.setattr(kw, "launch", launch)
    khy.reset_launch_counts()
    pack, scal, cls = khy.update_stage(k2, pack2, st.d_thr, cfg, strategy, st.needs_delta,
                                       st.lay, st.win.nv)
    args = seen["hybrid_update"]
    lay, n = st.lay, st.win.n
    assert args[6:9] == (n, st.win.nv, cfg.class_scale)
    assert args[9:15] == kp._step_args(strategy, st.needs_delta, cfg)[0:6]
    assert args[15:19] == (1, 0, -1, -1)
    assert args[19:] == (lay["t6"], lay["s6"], lay["b_nv"], lay["sv"], -1, -1, lay["new"],
                         lay["deg"], lay["maxd"])
    assert len(args) + 1 == len(build.ARGTYPES["hybrid_update"])  # and the stream
    assert pack.shape == pack2.shape and cls.shape == (n,) and scal.shape == (8, 128)
    assert khy.LAUNCHES == {"hybrid_vu": 0, "hybrid_update": 1}
    t6 = k2[lay["t6"] : lay["t6"] + 6]
    khy.vu_stage(t6, st.pack, cfg)
    assert seen["hybrid_vu"][1] == n  # the row pitch of K2's t6 rows
    assert seen["hybrid_vu"][4:] == (n, cfg.vu_tau, cfg.vu_damping)
    assert khy.LAUNCHES == {"hybrid_vu": 1, "hybrid_update": 1}
    khy.reset_launch_counts()


def test_wrappers_reject_other_devices_and_bad_operands(monkeypatch):
    cfg, st, t6, pack2, k2 = _stage_inputs(("flat", "edge", "feature"))
    strategy, nd, lay, nv = ("flat", "edge", "feature"), st.needs_delta, st.lay, st.win.nv
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        khy.vu_stage(t6.to("meta"), st.pack.to("meta"), cfg)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        khy.update_stage(k2.to("meta"), pack2.to("meta"), st.d_thr, cfg, strategy, nd, lay, nv)
    with pytest.raises(TypeError):
        khy.vu_stage(t6.double(), st.pack, cfg)
    with pytest.raises(ValueError, match="shape"):
        khy.vu_stage(t6[:, :-128], st.pack, cfg)
    with pytest.raises(ValueError, match="shape"):
        khy.update_stage(k2[:-8], pack2, st.d_thr, cfg, strategy, nd, lay, nv)
    with pytest.raises(ValueError, match="the other operands"):
        khy.vu_stage(t6, st.pack.to("meta"), cfg)

    # What only the kernels refuse: the plain stages take these on the CPU.
    monkeypatch.setattr(khy, "_on_cuda", lambda **kw_: True)
    monkeypatch.setattr(kw, "launch", lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match="slim pack"):
        khy.vu_stage(t6, st.pack.T.contiguous().T, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        khy.update_stage(k2, pack2.T.contiguous().T, st.d_thr, cfg, strategy, nd, lay, nv)
    with pytest.raises(ValueError, match="d_thr"):
        khy.update_stage(k2, pack2, st.d_thr.double(), cfg, strategy, nd, lay, nv)
    with pytest.raises(ValueError, match="d_thr"):
        khy.update_stage(k2, pack2, 0.01, cfg, strategy, nd, lay, nv)
    with pytest.raises(ValueError, match="nv"):
        khy.update_stage(k2, pack2, st.d_thr, cfg, strategy, nd, lay, st.win.n + 1)
    with pytest.raises(ValueError, match="lacks rows"):
        khy.update_stage(k2, pack2, st.d_thr, cfg, ("flat", "edge", "new"), (0, 2), lay, nv)
    with pytest.raises(ValueError, match="delta slot"):
        khy.update_stage(k2, pack2, st.d_thr, cfg, strategy, (), lay, nv)
    with pytest.raises(ValueError):
        khy.update_stage(k2, pack2, st.d_thr, cfg, ("flat", "edge", "sharpen"), nd, lay, nv)


def test_rows_must_be_contiguous_on_the_card():
    """A CUDA operand whose rows are strided is refused before any launch
    (checked on a stand-in that reports a CUDA device)."""
    x = torch.zeros((8, 256))

    class OnCard:
        device, dtype, shape = torch.device("cuda"), x.dtype, x.shape
        dim = x.dim

        def __init__(self, stride):
            self._stride = stride

        def stride(self, d):
            return self._stride[d]

    assert khy._on_cuda(pack=(OnCard((256, 1)), 8))
    with pytest.raises(ValueError, match="contiguous rows"):
        khy._on_cuda(pack=(OnCard((1, 8)), 8))
