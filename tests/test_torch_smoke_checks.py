"""chip_smoke.py's checks fail a wrong kernel.

On the card, ``chip_smoke.check_passes`` holds each pass kernel against
its plain version. Here, on the CPU, the wrappers run the plain versions,
so each case puts a wrong stand-in in a wrapper's place (a corner step
with a scaled right-hand side, a feature step without its ``sv`` sums, an
edge step with scaled ``b_nv`` sums, edge directions negated or moved by
1e-3; for the fused pass BD a partial x1.01, the next packs' normals
dropped, the lagged delta read from the wrong slot, a padding row moved)
and expects the check to end the run. The cloud is
``make_corner_cloud(16_384)``, where every class has over a hundred
points in the first iteration (``test_right_passes_pass`` asserts it),
so every step runs on over a hundred. For the window walk of K1, K2 and pass
BD a stand-in drops one 32-column word of every window, what an
over-eager word skip or a wrong tail mask would do, and must end
``check_kernels`` and ``check_pass_bd``; the same stand-in for any of
passes A-D must end ``check_passes``. A K0 whose rk_feat is one
bisection step off (23 steps), what a replay that lost a step would
give, must end ``check_kernels`` too.

``judge_train_step`` (chip_smoke's ``train_reference``) is held too, at a
narrow width (Patch2Normal hidden 16-64, the DGCNN at emb_dims 64, 64
patches each, dropout 0.5 with the same keep masks; the gradients held to
the CPU's own spread under a one-ulp nudge of the batch): a right step (the
CPU's on two threads against four, another summation order) passes, and
wrong stand-ins are refused: TF32 in the products (emulated: operands
rounded to 10 mantissa bits in the forward), torch's unbiased running
variance, momentum 0.9 in torch's convention (0.1 old + 0.9 batch), the
two-pass variance in place of Flax's fast one in the DGCNN (refused by
``fast_variance_probe``: on a step's own data the two agree within
rounding), and a dropout mask drawn anew between the forward and the
backward.

``check_dense_stage_kernels`` (chip_smoke's ``kernels`` and
``dense_stage_variants``) is held the same way on the same 16,384 points:
``denoise_iteration`` reaches the wrappers of ``kernels/dense.py``, which
run their plain versions here, and wrong stand-ins must end the run (the
smoothed normals moved by 1e-6, the edge directions negated, the update's
step scaled by 1.01, the deltas scaled by 1.01, the classes rolled by one
point in the update).

The learned point track's agreement checks (``judge_point_model``,
``judge_point_normals``) are held here too, at a narrow width on a small
merged scan: a right run (the path on its input nudged by one ulp once
more) passes, and three wrong stand-ins are refused by one of them: TF32
in the products (emulated: operands rounded to 10 mantissa bits), an
unbiased BatchNorm variance in the train-mode step, and the intra-patch
kNN keeping the higher index among ties.
"""

import functools
from types import SimpleNamespace

import pytest
import torch

import chip_smoke as cs
from ngpd_tpu_torch.bench import SPREAD_SEEDS, nudged
from ngpd_tpu_torch.config import ModelConfig
from ngpd_tpu_torch.core import patches as point_patches
from ngpd_tpu_torch.models import dgcnn as dgcnn_mod
from ngpd_tpu_torch.models import dropout as dropout_mod
from ngpd_tpu_torch.models import edgeconv
from ngpd_tpu_torch.models import patch2normal as p2n_mod
from ngpd_tpu_torch.bench import make_cloud, make_corner_cloud
from ngpd_tpu_torch.config import DenoiseConfig
from ngpd_tpu_torch.core.cuda_fused import passes_prologue, prologue
from ngpd_tpu_torch.kernels import dense as kdense
from ngpd_tpu_torch.kernels import passes as kp
from ngpd_tpu_torch.kernels import window as kw

torch.set_num_threads(2)

CFG = DenoiseConfig(feature_k=32, step_k=8)
CORNER_FEATURE = ("new", "corner", "feature")
EDGE_CORNER = ("dummy", "edge", "corner")


@functools.lru_cache(maxsize=None)
def _state(strategy):
    pts, nrm, _ = make_corner_cloud(16_384)
    # 100 trailing rows are padding, so pass BD's pinning is held too.
    return passes_prologue(pts, nrm, CFG, strategy, num_valid=16_284, device="cpu")


def _pass_d_with(name, wrong):
    """pass_d_plain with kernels/passes.py's ``name`` replaced by
    ``wrong(original)`` while it runs."""
    def pass_d(*args, **kwargs):
        original = getattr(kp, name)
        setattr(kp, name, wrong(original))
        try:
            return kp.pass_d_plain(*args, **kwargs)
        finally:
            setattr(kp, name, original)
    return pass_d


def _pass_b_edge(change):
    def pass_b(*args, **kwargs):
        cls, parts = kp.pass_b_plain(*args, **kwargs)
        return torch.cat([cls[0:1], change(cls[1:4])]), parts
    return pass_b


def _pass_bd_with(change):
    """pass_bd_plain with its outputs (gq, gr, cls, parts) changed."""
    def pass_bd(*args, **kwargs):
        return change(*kp.pass_bd_plain(*args, **kwargs))
    return pass_bd


def _scaled_partial(gq, gr, cls, parts):
    parts = parts.clone()
    parts[4] *= 1.01  # the first delta class's max |p_j - centre|^2
    return gq, gr, cls, parts


def _normals_dropped(gq, gr, cls, parts):
    gq = gq.clone()
    gq[5:8] = 0.0
    return gq, gr, cls, parts


def _padding_moved(gq, gr, cls, parts):
    gq = gq.clone()
    gq[0, -1] += 1e-3
    return gq, gr, cls, parts


def _pass_bd_wrong_slot(gq2, gr2, scal, *args, **kwargs):
    """Every delta class reads the next class's delta."""
    wrong = scal.clone()
    wrong[1:4, 0] = torch.roll(scal[1:4, 0], 1)
    return kp.pass_bd_plain(gq2, gr2, wrong, *args, **kwargs)


ALL_DELTA = ("flat", "new", "flat")

MUTANTS = {
    "bd-partial": (CORNER_FEATURE, "pass_bd", _pass_bd_with(_scaled_partial)),
    "bd-normals-dropped": (EDGE_CORNER, "pass_bd", _pass_bd_with(_normals_dropped)),
    "bd-wrong-slot": (ALL_DELTA, "pass_bd", _pass_bd_wrong_slot),
    "bd-padding-moved": (CORNER_FEATURE, "pass_bd", _pass_bd_with(_padding_moved)),
    "corner-rhs": (CORNER_FEATURE, "pass_d", _pass_d_with(
        "solve3x3_components",
        lambda f: lambda rows, b, p: f(rows, tuple(x * 1.01 for x in b), p))),
    "feature-sv": (CORNER_FEATURE, "pass_d", _pass_d_with(
        "three_term_solve",
        lambda f: lambda n, p, deg, s6, b, sv: f(n, p, deg, s6, b, tuple(0 * x for x in sv)))),
    "edge-bnv": (EDGE_CORNER, "pass_d", _pass_d_with(
        "edge_solve",
        lambda f: lambda y, s6, b, q, deg, p: f(y, s6, tuple(1.01 * x for x in b), q, deg, p))),
    "edge-dir-negated": (CORNER_FEATURE, "pass_b", _pass_b_edge(lambda y: -y)),
    "edge-dir-moved": (CORNER_FEATURE, "pass_b", _pass_b_edge(lambda y: y + 1e-3)),
}


@pytest.fixture
def no_cuda_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


@pytest.mark.parametrize("strategy", [CORNER_FEATURE, EDGE_CORNER, ALL_DELTA], ids="-".join)
def test_right_passes_pass(no_cuda_sync, strategy):
    """With the wrappers as they are, every check holds and every class
    has at least MIN_CLASS_POINTS points."""
    _, checks = cs.check_passes(CFG, _state(strategy), strategy, timed=False,
                                min_class=cs.MIN_CLASS_POINTS)
    assert min(checks["PASS_B"]["class_counts"].values()) >= cs.MIN_CLASS_POINTS
    assert all(v > 0 for k, v in checks["PASS_D"]["moved"].items()
               if strategy[int(k[-1])] != "dummy")
    assert all(v > 0 for k, v in checks["PASS_BD"]["moved"].items()
               if not k.endswith("dummy"))
    assert len(set(checks["PASS_BD"]["deltas"])) == len(checks["PASS_BD"]["deltas"])


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_wrong_pass_fails(no_cuda_sync, monkeypatch, mutant):
    strategy, wrapper, wrong = MUTANTS[mutant]
    monkeypatch.setattr(kp, wrapper, wrong)
    with pytest.raises(SystemExit):
        cs.check_passes(CFG, _state(strategy), strategy, timed=False,
                        min_class=cs.MIN_CLASS_POINTS)


@functools.lru_cache(maxsize=None)
def _dense_ops():
    return cs.dense_operands(make_corner_cloud, 16_384, CFG, device="cpu")


_UPDATE = kdense.update


def _wrong(name, change):
    original = getattr(kdense, name)
    return name, lambda *a: change(original(*a), *a)


DENSE_MUTANTS = {
    "vote-normals-moved": _wrong("vote", lambda f, *a: f + 1e-6),
    "classify-edge-negated": _wrong("classify", lambda out, *a: (out[0], -out[1], out[2])),
    "update-step-scaled": _wrong("update", lambda p, pts, *a: pts + 1.01 * (p - pts)),
    "deltas-scaled": _wrong("class_deltas", lambda d, *a: d * 1.01),
    "update-classes-rolled": _wrong("update", lambda p, pts, f, ns, cls, *a: _UPDATE(
        pts, f, ns, torch.roll(cls, 1), *a)),
}


@pytest.mark.parametrize("strategy", cs.STRATEGIES + (ALL_DELTA,), ids="-".join)
def test_right_dense_stage_kernels_pass(strategy):
    rec = cs.check_dense_stage_kernels(_dense_ops(), CFG, strategy, timed=False)
    assert min(rec[4]["classes"]) >= cs.MIN_CLASS_POINTS
    # Each record carries its measured gap: nothing here (both sides run
    # the plain versions), none where nothing is summed.
    gaps = {r["name"]: r["max_abs_err"] for r in rec}
    summed = 0.0 if kdense.delta_classes(strategy) else None
    assert gaps == {"DENSE_VOTE": 0.0, "DENSE_CLASSIFY": 0.0, "DENSE_SUMS": None,
                    "DENSE_DELTA": summed, "DENSE_UPDATE": 0.0}


@pytest.mark.parametrize("mutant", list(DENSE_MUTANTS))
def test_wrong_dense_stage_kernel_fails(monkeypatch, mutant):
    name, wrong = DENSE_MUTANTS[mutant]
    monkeypatch.setattr(kdense, name, wrong)
    with pytest.raises(SystemExit):
        cs.check_dense_stage_kernels(_dense_ops(), CFG, ALL_DELTA, timed=False)


def test_missing_class_fails(no_cuda_sync):
    """A class the strategy maps to a step with too few points ends the
    run: the roof-like cloud of the old variants would."""
    with pytest.raises(SystemExit):
        cs.check_passes(CFG, _state(CORNER_FEATURE), CORNER_FEATURE, timed=False,
                        min_class=10_000)


# ---------------------------------------------------------------------------
# The window walk: a dropped word
# ---------------------------------------------------------------------------

DROPPED_WORD = 6  # columns 192-223 of every window: near the tile's first queries
DEFAULT = ("flat", "edge", "feature")


def _without_word(valid: torch.Tensor) -> torch.Tensor:
    valid = valid.clone()
    valid[..., 32 * DROPPED_WORD : 32 * (DROPPED_WORD + 1)] = False
    return valid


def _k2_dropping_a_word(*args, **kwargs):
    """The plain K2 on windows whose word DROPPED_WORD reads as masked."""
    original = kw._col_valid
    kw._col_valid = lambda *a: _without_word(original(*a))
    try:
        return kw.k2_plain(args[0], args[1], args[2], kw.cos_f32(args[3]), *args[4:], **kwargs)
    finally:
        kw._col_valid = original


def _dropping_a_word(plain):
    """The plain pass ``plain`` (a name in kernels/passes.py) on windows
    whose word DROPPED_WORD reads as masked."""
    def run(*args, **kwargs):
        original = kp._window

        def window(*a):
            wr, valid = original(*a)
            return wr, _without_word(valid)

        kp._window = window
        try:
            return getattr(kp, plain)(*args, **kwargs)
        finally:
            kp._window = original
    return run


_pass_bd_dropping_a_word = _dropping_a_word("pass_bd_plain")


@functools.lru_cache(maxsize=None)
def _hybrid_state():
    pts, nrm, _ = make_cloud(8_192)
    return prologue(pts, nrm, CFG, DEFAULT, num_valid=8_100, device="cpu")


def test_right_window_kernels_pass(no_cuda_sync):
    rec = cs.check_kernels(CFG, _hybrid_state(), DEFAULT, timed=False)
    assert [r["name"] for r in rec] == ["K0", "K1", "K2"]
    assert all(r["max_abs_err"] == 0.0 for r in rec)  # the plain versions both times


def test_k2_that_drops_a_word_fails(no_cuda_sync, monkeypatch):
    monkeypatch.setattr(kw, "k2", _k2_dropping_a_word)
    with pytest.raises(SystemExit):
        cs.check_kernels(CFG, _hybrid_state(), DEFAULT, timed=False)


def _k1_dropping_a_word(pack, win, angle):
    """The plain K1 on windows whose word DROPPED_WORD reads as masked."""
    original = kw._col_valid
    kw._col_valid = lambda *a: _without_word(original(*a))
    try:
        return kw.k1_plain(pack, win, kw.cos_f32(angle))
    finally:
        kw._col_valid = original


def _k0_rk_feat_a_step_off(pack, win, feature_k, step_k):
    """The plain K0 with rk_feat after 23 bisection steps instead of 24."""
    out = kw.k0_plain(pack, win, feature_k, step_k)
    steps = kw._SEARCH_ITERS
    kw._SEARCH_ITERS = steps - 1
    try:
        out[0] = kw.k0_plain(pack, win, feature_k, step_k)[0]
    finally:
        kw._SEARCH_ITERS = steps
    return out


WINDOW_MUTANTS = {"k1-dropped-word": ("k1", _k1_dropping_a_word),
                  "k0-rk-feat-a-step-off": ("k0", _k0_rk_feat_a_step_off)}


@pytest.mark.parametrize("mutant", list(WINDOW_MUTANTS))
def test_wrong_window_kernel_fails(no_cuda_sync, monkeypatch, mutant):
    wrapper, wrong = WINDOW_MUTANTS[mutant]
    monkeypatch.setattr(kw, wrapper, wrong)
    with pytest.raises(SystemExit):
        cs.check_kernels(CFG, _hybrid_state(), DEFAULT, timed=False)


def _pass_a_packs(strategy):
    st = _state(strategy)
    return st, kp.pass_a_plain(st.gq, st.gr, st.win, CFG)


@pytest.mark.parametrize("strategy", [EDGE_CORNER, ALL_DELTA], ids="-".join)
def test_right_pass_bd_passes(no_cuda_sync, strategy):
    st, (gq2, gr2) = _pass_a_packs(strategy)
    rec = {}
    cs.check_pass_bd(CFG, st, strategy, gq2, gr2, rec)
    assert rec["PASS_BD"]["class_flips"] == 0 and rec["PASS_BD"]["max_abs_err"] == 0.0


@pytest.mark.parametrize("strategy", [EDGE_CORNER, ALL_DELTA], ids="-".join)
def test_pass_bd_that_drops_a_word_fails(no_cuda_sync, monkeypatch, strategy):
    st, (gq2, gr2) = _pass_a_packs(strategy)
    monkeypatch.setattr(kp, "pass_bd", _pass_bd_dropping_a_word)
    with pytest.raises(SystemExit):
        cs.check_pass_bd(CFG, st, strategy, gq2, gr2, {})


# Pass C runs only for a strategy with a delta class.
WALKED = [(w, s) for w in ("pass_a", "pass_b", "pass_d") for s in (EDGE_CORNER, ALL_DELTA)]
WALKED += [("pass_c", CORNER_FEATURE), ("pass_c", ALL_DELTA)]


@pytest.mark.parametrize("wrapper,strategy", WALKED,
                         ids=[f"{w}-{'-'.join(s)}" for w, s in WALKED])
def test_pass_that_drops_a_word_fails(no_cuda_sync, monkeypatch, wrapper, strategy):
    """Passes A-D walk the window as pass BD does: a walk that loses a
    word ends check_passes (pass A's on the turned normals)."""
    monkeypatch.setattr(kp, wrapper, _dropping_a_word(f"{wrapper}_plain"))
    with pytest.raises(SystemExit):
        cs.check_passes(CFG, _state(strategy), strategy, timed=False,
                        min_class=cs.MIN_CLASS_POINTS)


NARROW_P2N = ModelConfig(hidden=(16, 16, 32, 32, 32, 32, 64, 32, 16), dropout_rate=0.0)


@pytest.fixture(scope="module")
def point_ref():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "POINT_REF_CFG", NARROW_P2N)
        u, nrm, cloud = cs.merged_scan(160, 80)
        nrm = torch.as_tensor(nrm)
        pts = torch.as_tensor(cloud(u))
        model = cs.refreshed_model(pts, nrm, "cpu")
        b = point_patches.extract_patches(pts, nrm, device="cpu")
        with torch.no_grad():
            outputs = model(b.x, b.nbr_idx, b.nbr_mask, b.node_mask)
        return SimpleNamespace(
            u=u, nrm=nrm, cloud=cloud, patches=b, outputs=outputs,
            base=cs.point_run(pts, nrm, "cpu"),
            spreads=[cs.point_run(torch.as_tensor(cloud(nudged(u, s))), nrm, "cpu")
                     for s in SPREAD_SEEDS])


def _point_judges(ref, got_normals, got_outputs):
    return (cs.judge_point_model(got_outputs, ref.outputs),
            cs.judge_point_normals(got_normals, ref.base, ref.spreads, ref.base))


def _point_path(ref, pts):
    model = cs.refreshed_model(pts, ref.nrm, "cpu")
    b = ref.patches
    with torch.no_grad():
        outputs = model(b.x, b.nbr_idx, b.nbr_mask, b.node_mask)
    return cs.point_run(pts, ref.nrm, "cpu"), outputs


def test_right_point_run_passes(point_ref, monkeypatch):
    monkeypatch.setattr(cs, "POINT_REF_CFG", NARROW_P2N)
    normals, outputs = _point_path(point_ref, torch.as_tensor(point_ref.cloud(
        nudged(point_ref.u, 11))))
    model_rec, normals_rec = _point_judges(point_ref, normals, point_ref.outputs)
    print("right", model_rec, normals_rec)
    assert model_rec["ok"] and normals_rec["ok"], (model_rec, normals_rec)
    # The model alone, on identical inputs in two halves (another blocking).
    half = point_ref.patches.x.shape[0] // 2
    model = cs.refreshed_model(torch.as_tensor(point_ref.cloud(point_ref.u)), point_ref.nrm, "cpu")
    b = point_ref.patches
    with torch.no_grad():
        parts = [model(b.x[s], b.nbr_idx[s], b.nbr_mask[s], b.node_mask[s])
                 for s in (slice(0, half), slice(half, None))]
    assert cs.judge_point_model(torch.cat(parts), point_ref.outputs)["ok"]


def _tf32(x):
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        return x
    b = x.contiguous().view(torch.int32)
    return ((b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def _tf32_products(monkeypatch):
    matmul = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda a, b: matmul(_tf32(a), _tf32(b)))


def _unbiased_variance(monkeypatch):
    forward = edgeconv.MaskedBatchNorm.forward

    def unbiased(self, x, mask, group=None):
        if not self.training:
            return forward(self, x, mask, group)
        m = mask.to(x.dtype)[..., None]
        dims = tuple(range(x.dim() - 1))
        cnt = torch.clamp(torch.sum(m), min=1.0)
        mean = torch.sum(x * m, dim=dims) / cnt
        var = torch.sum((x - mean) ** 2 * m, dim=dims) / torch.clamp(cnt - 1.0, min=1.0)
        with torch.no_grad():
            self.running_mean.copy_(0.9 * self.running_mean + (1 - 0.9) * mean)
            self.running_var.copy_(0.9 * self.running_var + (1 - 0.9) * var)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias

    monkeypatch.setattr(edgeconv.MaskedBatchNorm, "forward", unbiased)


def _patch_knn_higher_index_first(monkeypatch):
    knn = point_patches.masked_pair_knn

    def higher(x, node_mask, k):
        idx, mask = knn(torch.flip(x, [1]), torch.flip(node_mask, [1]), k)
        return torch.where(mask, x.shape[1] - 1 - idx, 0), mask

    monkeypatch.setattr(point_patches, "masked_pair_knn", higher)


POINT_MUTANTS = {"tf32_products": _tf32_products, "unbiased_bn_variance": _unbiased_variance,
                 "patch_knn_higher_index_first": _patch_knn_higher_index_first}


@pytest.mark.parametrize("mutant", list(POINT_MUTANTS))
def test_wrong_point_path_fails(point_ref, monkeypatch, mutant):
    monkeypatch.setattr(cs, "POINT_REF_CFG", NARROW_P2N)
    POINT_MUTANTS[mutant](monkeypatch)
    normals, outputs = _point_path(point_ref, torch.as_tensor(point_ref.cloud(point_ref.u)))
    model_rec, normals_rec = _point_judges(point_ref, normals, outputs)
    print(mutant, model_rec, normals_rec)
    assert not (model_rec["ok"] and normals_rec["ok"]), (model_rec, normals_rec)


NARROW_TRAIN = ModelConfig(hidden=(16, 16, 32, 32, 32, 32, 64, 32, 16))


def _narrow_train(mp):
    mp.setattr(cs, "TRAIN_REF_P2N_CFG", NARROW_TRAIN)
    mp.setattr(cs, "TRAIN_REF_EMB", 64)
    mp.setattr(cs, "MESH_TRAIN_BATCH", 64)


@pytest.fixture(scope="module")
def train_ref():
    """The CPU's step on four threads and its spread under a one-ulp nudge."""
    with pytest.MonkeyPatch.context() as mp:
        _narrow_train(mp)
        inputs = cs.train_reference_inputs()
        torch.set_num_threads(4)
        try:
            want, spread = {}, {}
            for kind, (weights, batch, keep) in inputs.items():
                want[kind] = cs.train_step_on(kind, "cpu", weights, batch, keep)
                spread[kind] = cs.compare_train_steps(cs.train_step_on(
                    kind, "cpu", weights, cs.nudged_batch(kind, batch, 9), keep), want[kind])
        finally:
            torch.set_num_threads(2)
        return inputs, want, spread


def _train_judges(train_ref, kinds=("patch2normal", "dgcnn")):
    """The step on two threads (another summation order) against the
    fixture's, under ``judge_train_step``; for the DGCNN also the batch
    variance's probe, as ``check_train_reference`` runs it."""
    inputs, want, spread = train_ref
    with pytest.MonkeyPatch.context() as mp:
        _narrow_train(mp)
        recs = {kind: cs.judge_train_step(kind, cs.train_step_on(kind, "cpu", *inputs[kind]),
                                          want[kind], spread[kind]) for kind in kinds}
    if "dgcnn" in recs:
        probe = cs.fast_variance_probe("cpu")
        recs["dgcnn"]["fast_variance"] = probe
        recs["dgcnn"]["ok"] = recs["dgcnn"]["ok"] and probe["ok"]
    return recs


def test_right_training_steps_pass(train_ref):
    recs = _train_judges(train_ref)
    print("right", recs, "spread", train_ref[2])
    assert all(r["ok"] for r in recs.values()), recs


def _tf32_st(x):
    """TF32 rounding of a float32 operand, the gradient passed straight."""
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        return x
    return x + (_tf32(x.detach()) - x).detach()


def _tf32_training(monkeypatch):
    matmul, mm, linear = torch.matmul, torch.Tensor.__matmul__, torch.nn.functional.linear
    monkeypatch.setattr(torch, "matmul", lambda a, b: matmul(_tf32_st(a), _tf32_st(b)))
    monkeypatch.setattr(torch.Tensor, "__matmul__", lambda a, b: mm(_tf32_st(a), _tf32_st(b)))
    monkeypatch.setattr(torch.nn.functional, "linear",
                        lambda x, w, b=None: linear(_tf32_st(x), _tf32_st(w), b))


def _unbiased_running_variance(monkeypatch):
    """torch's BatchNorm keeps n / (n - 1) x the batch variance."""
    forward, bn = edgeconv.MaskedBatchNorm.forward, dgcnn_mod._bn

    def masked(self, x, mask, group=None):
        before = self.running_var.clone()
        y = forward(self, x, mask, group)
        if self.training:
            n = float(mask.sum())
            with torch.no_grad():
                batch = (self.running_var - 0.9 * before) / 0.1
                self.running_var.copy_(0.9 * before + 0.1 * batch * n / (n - 1))
        return y

    def dense(h, module, training=False, group=None):
        before = module.running_var.clone()
        y = bn(h, module, training, group)
        if training:
            n = h.numel() // h.shape[-1]
            with torch.no_grad():
                batch = (module.running_var - 0.9 * before) / 0.1
                module.running_var.copy_(0.9 * before + 0.1 * batch * n / (n - 1))
        return y

    monkeypatch.setattr(edgeconv.MaskedBatchNorm, "forward", masked)
    monkeypatch.setattr(dgcnn_mod, "_bn", dense)


def _torch_momentum(monkeypatch):
    """momentum=0.9 in torch's convention: 0.1 x old + 0.9 x batch."""
    monkeypatch.setattr(edgeconv, "BN_MOMENTUM", 0.1)
    monkeypatch.setattr(dgcnn_mod, "BN_MOMENTUM", 0.1)


def _two_pass_variance(monkeypatch):
    def stats(h, group=None):
        dims = tuple(range(h.dim() - 1))
        mean = torch.mean(h, dim=dims)
        return mean, torch.mean((h - mean) ** 2, dim=dims)

    monkeypatch.setattr(dgcnn_mod, "batch_stats", stats)


class _RedrawnDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, keep, rate):
        ctx.rate, ctx.shape = rate, h.shape
        return torch.where(keep, h / (1.0 - rate), 0.0)

    @staticmethod
    def backward(ctx, g):
        fresh = torch.rand(ctx.shape) < 1.0 - ctx.rate
        return torch.where(fresh, g / (1.0 - ctx.rate), 0.0), None, None


def _dropout_redrawn(monkeypatch):
    """A keep mask drawn anew between the forward and the backward."""
    torch.manual_seed(0)
    for mod in (p2n_mod, dgcnn_mod, dropout_mod):
        monkeypatch.setattr(mod, "apply_dropout", _RedrawnDropout.apply)


TRAIN_MUTANTS = {"tf32": (_tf32_training, ("patch2normal", "dgcnn")),
                 "unbiased_running_variance": (_unbiased_running_variance,
                                               ("patch2normal", "dgcnn")),
                 "torch_momentum_convention": (_torch_momentum, ("patch2normal", "dgcnn")),
                 "two_pass_variance": (_two_pass_variance, ("dgcnn",)),
                 "dropout_mask_redrawn": (_dropout_redrawn, ("patch2normal", "dgcnn"))}


@pytest.mark.parametrize("mutant,kind", [(m, k) for m, (_, kinds) in TRAIN_MUTANTS.items()
                                         for k in kinds])
def test_wrong_training_step_fails(train_ref, monkeypatch, mutant, kind):
    TRAIN_MUTANTS[mutant][0](monkeypatch)
    rec = _train_judges(train_ref, (kind,))[kind]
    print(mutant, kind, rec)
    assert not rec["ok"], rec
