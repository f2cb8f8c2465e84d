"""The dense pipeline's stage kernels (``kernels/dense.py``).

On the CPU: ``denoise_iteration`` runs through the wrappers, which run the
plain functions of ``core/voting.py``, ``core/pipeline.py::_class_delta``
and ``core/denoise.py`` and launch nothing, and gives the eager iteration
(every step run densely, then selected by class) bit for bit, with and
without the sharded arguments; CUDA operands reach the kernel build and
launch, never the plain functions, with the sharded arguments too (the
source rows' pointers, the gather of the smoothed normals, the
all-reduces of the centre sums and the delta maxima); operands the
kernels cannot take raise.

On the card (skipped without one; the CUDA kernels have no CPU mode): the
kernels against the plain versions on the same card tensors. The smoothed
normals, classes and edge directions are equal; so are the new positions
of every point whose class takes no delta, and of every point when the
update kernel is fed the eager deltas. The kernels' own deltas sum their
centres per block, then over the blocks, where the eager stage sums all
points at once: a centre is then off by an ulp or two of the coordinates,
so the deltas are held within 5e-7 of the cloud's extent (4 of its ulps),
and the positions of the flat and new classes within 1e-5 of it. A delta
an ulp off moves every weight of its class a little; the new step's
system has right sides of about (2 + step_k) |p|, whose roundings then
move a solution by tens of ulps of the extent (2.7e-6 on the 1.8-wide
roof, H100), the flat step's by one. Past ``MAX_K`` neighbours a row
PyTorch sums in other orders than the kernels: there each stage, fed the
plain outputs before it, is held within its rounding (WIDE_* below).
"""

import numpy as np
import pytest
import torch

from ngpd_tpu_torch.bench import make_cloud, make_corner_cloud
from ngpd_tpu_torch.config import DenoiseConfig
from ngpd_tpu_torch.core import denoise as steps
from ngpd_tpu_torch.core import pipeline, voting
from ngpd_tpu_torch.core.pipeline import _class_delta, denoise, denoise_iteration, step_threshold
from ngpd_tpu_torch.kernels import build
from ngpd_tpu_torch.kernels import dense as kd
from ngpd_tpu_torch.kernels import window as kw
from ngpd_tpu_torch.ops.knn import knn
from ngpd_tpu_torch.ops.neighbors import Neighborhood

torch.set_num_threads(2)

# Every step of ops/steps.py::STEP_NAMES in some class.
STRATEGIES = [("flat", "edge", "feature"), ("new", "corner", "feature"),
              ("dummy", "edge", "corner"), ("flat", "new", "flat"),
              ("corner", "feature", "new")]
CFG = DenoiseConfig(feature_k=16, step_k=7)
NO_LAUNCH = {name: 0 for name in kd.LAUNCHES}
DELTA_TOL = 5e-7  # of the cloud's extent
POS_TOL = 1e-5  # of the cloud's extent, the flat and new classes' positions
# Past MAX_K: sums of ~130 terms in another order, each off by its
# rounding, about k ulps at worst. The smoothed normals are unit vectors;
# a class sits on a threshold of eigenvalue ratios, so a point or two of
# the cloud may change class.
WIDE_NORMAL_TOL = 1e-5
WIDE_CLASS_SHARE = 0.999


def _operands(n=1_500, cfg=CFG, drop=False, device="cpu", num_valid=None):
    """Tiled cube corners (every class common) with their normals, both
    neighbourhoods and the step threshold; ``drop`` invalidates the last
    three slots of every fifth row and every slot of row 5."""
    noisy, nrm, _ = make_corner_cloud(n)
    pts = torch.as_tensor(noisy).to(device)
    nrm = torch.as_tensor(nrm).to(device)
    nf = knn(pts, cfg.feature_k, num_valid=num_valid)[0]
    ns = knn(pts, cfg.step_k, num_valid=num_valid)[0]
    if drop:
        nf, ns = (Neighborhood(nb.idx, _dropped(nb.mask)) for nb in (nf, ns))
    d = cfg.d_scale / 2.0 * step_threshold(pts, num_valid)
    return pts, nrm, nf, ns, d


def _dropped(mask):
    mask = mask.clone()
    mask[::5, -3:] = False
    mask[5] = False
    return mask


def _iteration_args(ops, strategy, cfg=CFG):
    pts, nrm, nf, ns, d = ops
    return (pts, nrm, nf, ns, d, cfg.alphas, cfg.angle, cfg.class_scale, strategy,
            cfg.vu_tau, cfg.vu_damping)


def _composed(ops, strategy, cfg=CFG):
    """denoise_iteration from the four wrappers."""
    pts, nrm, nf, ns, d = ops
    classes = kd.delta_classes(strategy)
    f_n = kd.vote(pts, nrm, nf, cfg.angle, cfg.vu_tau, cfg.vu_damping)
    cls, edge, parts = kd.classify(pts, f_n, nf, cfg.angle, cfg.class_scale, ns, classes)
    deltas = kd.class_deltas(pts, ns, cls, classes, parts)
    return kd.update(pts, f_n, ns, cls, edge, deltas, d, cfg.alphas, strategy), f_n, cls


def _eager_iteration(points, normals, nbh_feat, nbh_step, d, alphas, angle, class_scale,
                     strategy, vu_tau, vu_damping, src_points=None, src_normals=None,
                     gather_fn=None, axis_name=None):
    """The eager iteration as the pipeline ran it before the stage kernels:
    every configured step over every point, then the select by class."""
    nvt1 = voting.better_filtered_nvt(points, nbh_feat, normals, angle, src_points,
                                      src_normals)
    f_n = voting.vu_smoothed_normals(nvt1, normals, vu_tau, vu_damping)
    src_f_n = gather_fn(f_n) if gather_fn is not None else None
    decomp = voting.better_filtered_nvt(points, nbh_feat, f_n, angle, src_points, src_f_n)
    cls = voting.classes(decomp, class_scale)
    edge = decomp.eigvec[..., 0]
    src = {"src_points": src_points, "src_normals": src_f_n}
    by_class = []
    for c, name in enumerate(strategy):
        alpha = alphas[c]
        if name in ("flat", "new"):
            delta = _class_delta(points, nbh_step, cls == c, src_points, axis_name)
            step = steps.flat_step if name == "flat" else steps.new_step
            by_class.append(step(points, nbh_step, f_n, d, alpha, delta=delta, **src))
        elif name == "edge":
            by_class.append(steps.edge_step(points, nbh_step, f_n, edge, d, alpha, **src))
        elif name == "corner":
            by_class.append(steps.corner_step(points, nbh_step, f_n, d, alpha, **src))
        elif name == "feature":
            by_class.append(steps.feature_step(points, nbh_step, f_n, d, alpha, **src))
        else:
            by_class.append(steps.dummy_step(points, nbh_step, f_n, d, alpha))
    new_pos = torch.where((cls == 0)[:, None], by_class[0],
                          torch.where((cls == 1)[:, None], by_class[1], by_class[2]))
    return new_pos, f_n, cls


def _plain_iteration(ops, strategy, cfg=CFG):
    """One iteration from the plain versions of kernels/dense.py, with the
    eager edge directions and deltas."""
    pts, nrm, nf, ns, d = ops
    f_n = kd.vote_plain(pts, nrm, nf, cfg.angle, cfg.vu_tau, cfg.vu_damping)
    cls, edge = kd.classify_plain(pts, f_n, nf, cfg.angle, cfg.class_scale)
    deltas = kd.class_deltas_plain(pts, ns, cls, kd.delta_classes(strategy))
    return (kd.update_plain(pts, f_n, ns, cls, edge, deltas, d, cfg.alphas, strategy), f_n,
            cls, edge.contiguous(), deltas.contiguous())


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES, ids="-".join)
def test_cpu_wrappers_compose_to_the_plain_iteration(strategy, drop):
    """On CPU tensors denoise_iteration and the four wrappers composed give
    the eager iteration's positions, smoothed normals and classes bit for
    bit, and launch nothing."""
    ops = _operands(drop=drop)
    kd.reset_launch_counts()
    want = _eager_iteration(*_iteration_args(ops, strategy))
    for got in (denoise_iteration(*_iteration_args(ops, strategy)), _composed(ops, strategy)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert kd.LAUNCHES == NO_LAUNCH
    assert len(set(want[2].tolist())) == 3  # every class takes its step


def test_cpu_wrappers_return_the_plain_functions():
    pts, nrm, nf, ns, d = ops = _operands()
    cfg = CFG
    nvt1 = voting.better_filtered_nvt(pts, nf, nrm, cfg.angle)
    f_n = voting.vu_smoothed_normals(nvt1, nrm, cfg.vu_tau, cfg.vu_damping)
    assert torch.equal(kd.vote(pts, nrm, nf, cfg.angle, cfg.vu_tau, cfg.vu_damping), f_n)
    decomp = voting.better_filtered_nvt(pts, nf, f_n, cfg.angle)
    cls, edge, parts = kd.classify(pts, f_n, nf, cfg.angle, cfg.class_scale, ns, (0, 2))
    assert torch.equal(cls, voting.classes(decomp, cfg.class_scale))
    assert torch.equal(edge, decomp.eigvec[..., 0]) and parts is None
    deltas = kd.class_deltas(pts, ns, cls, (0, 2), parts)
    assert deltas.shape == (3, 1) and float(deltas[1, 0]) == 0.0
    for c in (0, 2):
        assert torch.equal(deltas[c, 0], _class_delta(pts, ns, cls == c))
    strategy = ("flat", "edge", "new")
    want = steps.pick_by_class(cls, [
        steps.flat_step(pts, ns, f_n, d, cfg.alphas[0], delta=deltas[0, 0]),
        steps.edge_step(pts, ns, f_n, edge, d, cfg.alphas[1]),
        steps.new_step(pts, ns, f_n, d, cfg.alphas[2], delta=deltas[2, 0])])
    assert torch.equal(kd.update(pts, f_n, ns, cls, edge, deltas, d, cfg.alphas, strategy), want)
    del ops


@pytest.mark.parametrize("sharded", ["src_points", "src_normals", "gather_fn", "axis_name"])
def test_sharded_arguments_keep_the_plain_stages(sharded, monkeypatch):
    """On the CPU, with any sharded argument set, denoise_iteration gives
    the eager iteration with that argument bit for bit and launches
    nothing."""
    ops = _operands(n=600)
    pts, nrm = ops[0], ops[1]
    kwargs = {"src_points": pts, "src_normals": nrm, "gather_fn": lambda x: x,
              "axis_name": None}
    kwargs = {sharded: kwargs[sharded]}
    if sharded == "axis_name":  # a group of one rank: the reductions return their input
        monkeypatch.setattr(pipeline, "all_reduce", lambda x, op, group: x)
        kwargs["axis_name"] = object()
    monkeypatch.setattr(kw, "launch", lambda *a: pytest.fail("launched"))
    for strategy in (STRATEGIES[0], STRATEGIES[1]):
        want = _eager_iteration(*_iteration_args(ops, strategy), **kwargs)
        kd.reset_launch_counts()
        got = denoise_iteration(*_iteration_args(ops, strategy), **kwargs)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert kd.LAUNCHES == NO_LAUNCH


class _OnCard:
    """A stand-in that reports a CUDA device, for the checks alone."""

    def __init__(self, x):
        self._x = x
        self.dtype, self.shape, self.device = x.dtype, x.shape, torch.device("cuda")

    def dim(self):
        return self._x.dim()


def _recording_launch(monkeypatch):
    """Fake launches: the wrappers take their CUDA branch on CPU tensors
    and each launch records its arguments; returns [(name, args)]."""
    seen = []

    def launch(name, counts, *args):
        seen.append((name, args))
        counts[name] += 1

    monkeypatch.setattr(kd, "_on_cuda", lambda *a: True)
    monkeypatch.setattr(kw, "launch", launch)
    for fn in ("vote_plain", "classify_plain", "class_deltas_plain", "update_plain"):
        monkeypatch.setattr(kd, fn, lambda *a, **k: pytest.fail("ran a plain version"))
    return seen


@pytest.mark.parametrize("sharded", [False, True], ids=["one_device", "sharded"])
def test_denoise_iteration_takes_the_kernels_on_the_card(sharded, monkeypatch):
    """On the card denoise_iteration launches each stage kernel once, in
    the two spans, with or without the sharded arguments: sharded, the
    neighbours are read from the source rows, the smoothed normals are
    gathered between the vote and the classify, and the class deltas
    all-reduce the centre sums (before the delta kernel) and the delta
    maxima (after it)."""
    ops = _operands(n=600)
    pts, nrm, _, _, _ = ops
    seen = _recording_launch(monkeypatch)
    src_pts, src_nrm = pts.clone(), nrm.clone()
    gathered, gathered_f_n, reduced = [], [], []

    def gather(f_n):
        gathered.append(f_n)
        gathered_f_n.append(torch.zeros_like(f_n))
        return gathered_f_n[-1]

    def reduce(x, op, group):
        reduced.append((op, tuple(x.shape), group, [name for name, _ in seen]))
        return x

    monkeypatch.setattr(kd, "all_reduce", reduce)
    group = object()
    kwargs = ({"src_points": src_pts, "src_normals": src_nrm, "gather_fn": gather,
               "axis_name": group} if sharded else {})
    kd.reset_launch_counts()
    new_pos, f_n, cls = denoise_iteration(*_iteration_args(ops, STRATEGIES[0]), **kwargs)
    assert [name for name, _ in seen] == ["dense_vote", "dense_classify", "dense_sums",
                                          "dense_delta", "dense_update"]
    assert kd.LAUNCHES == {name: 1 for name in kd.LAUNCHES}
    args = dict(seen)
    own = (pts.data_ptr(), nrm.data_ptr())
    assert args["dense_vote"][:4] == own + ((src_pts.data_ptr(), src_nrm.data_ptr())
                                            if sharded else own)
    src_f = gathered_f_n[0] if sharded else f_n
    assert args["dense_classify"][:3] == (pts.data_ptr(), (src_pts if sharded else pts)
                                          .data_ptr(), src_f.data_ptr())
    assert args["dense_delta"][0] == (src_pts if sharded else pts).data_ptr()
    assert args["dense_update"][:4] == (pts.data_ptr(), f_n.data_ptr(),
                                        (src_pts if sharded else pts).data_ptr(),
                                        src_f.data_ptr())
    if sharded:
        assert len(gathered) == 1 and gathered[0] is f_n
        assert reduced == [("sum", (12,), group, ["dense_vote", "dense_classify",
                                                  "dense_sums"]),
                           ("max", (3, 1), group, ["dense_vote", "dense_classify",
                                                   "dense_sums", "dense_delta"])]
        assert args["dense_update"][10] == 1  # one column of reduced maxima
    else:
        assert gathered == [] and reduced == []
        assert args["dense_update"][10] == kd._blocks(pts.shape[0])  # per-block maxima
    assert new_pos.shape == pts.shape and cls.dtype == torch.int32


def test_cuda_operands_reach_the_launch_not_the_plain_functions(monkeypatch):
    """Operands that pass as CUDA go to the kernel build and launch: with no
    nvcc that raises, the plain functions are never called and no launch
    is counted."""
    try:
        build.find_nvcc()
        pytest.skip("nvcc is present; the missing-compiler path cannot be observed")
    except RuntimeError:
        pass
    pts, nrm, nf, ns, d = _operands(n=600)
    cls = torch.zeros(pts.shape[0], dtype=torch.int32)
    parts = torch.zeros((12, kd._blocks(pts.shape[0])))
    deltas = torch.zeros((3, 1))
    monkeypatch.setattr(kd, "_on_cuda", lambda *a: True)
    monkeypatch.setattr(build, "_LIBS", {})
    for mod, name in ((voting, "better_filtered_nvt"), (voting, "vu_smoothed_normals"),
                      (voting, "classes"), (steps, "class_step"), (steps, "pick_by_class"),
                      (pipeline, "_class_delta")):
        monkeypatch.setattr(mod, name, lambda *a, **k: pytest.fail("ran a plain function"))
    kd.reset_launch_counts()
    calls = (lambda: kd.vote(pts, nrm, nf, CFG.angle, CFG.vu_tau, CFG.vu_damping),
             lambda: kd.classify(pts, nrm, nf, CFG.angle, CFG.class_scale, ns, (0,)),
             lambda: kd.class_deltas(pts, ns, cls, (0,), parts),
             lambda: kd.update(pts, nrm, ns, cls, nrm, deltas, d, CFG.alphas, STRATEGIES[0]))
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert kd.LAUNCHES == NO_LAUNCH


def test_launches_carry_the_operands_and_count_once(monkeypatch):
    """Each wrapper launches its kernel once with the launch function's
    arguments in order; the sums' and deltas' kernels run only for flat
    and new."""
    pts, nrm, nf, ns, d = _operands(n=600)
    n = pts.shape[0]
    seen = _recording_launch(monkeypatch)
    kd.reset_launch_counts()
    f_n = kd.vote(pts, nrm, nf, CFG.angle, CFG.vu_tau, CFG.vu_damping)
    args = dict(seen)
    assert args["dense_vote"][6:11] == (n, CFG.feature_k, CFG.angle, CFG.vu_tau,
                                        CFG.vu_damping)
    cls, edge, parts = kd.classify(pts, f_n, nf, CFG.angle, CFG.class_scale, ns, (0, 2))
    args = dict(seen)
    assert args["dense_classify"][5] == CFG.feature_k
    assert args["dense_classify"][8:13] == (CFG.step_k, n, CFG.angle, CFG.class_scale, 0b101)
    assert cls.dtype == torch.int32 and parts.shape == (12, -(-n // kd.THREADS))
    deltas = kd.class_deltas(pts, ns, cls, (0, 2), parts)
    args = dict(seen)
    assert deltas.shape == (3, parts.shape[1])
    assert args["dense_sums"][:3] == (parts.data_ptr(), parts.shape[1], 0b101)
    assert args["dense_delta"][3] == CFG.step_k
    assert args["dense_delta"][5:8] == (args["dense_sums"][3], n, 0b101)
    kd.update(pts, f_n, ns, cls, edge, deltas, d, CFG.alphas, ("flat", "edge", "new"))
    args = dict(seen)["dense_update"]
    assert args[10:14] == (parts.shape[1], 0b101, d.data_ptr(), 0.0)
    assert args[14:21] == (0, 1, 4, *map(float, CFG.alphas), n)
    for name, launched in dict(seen).items():
        assert len(launched) + 1 == len(build.ARGTYPES[name])  # and the stream
    assert kd.LAUNCHES == {name: 1 for name in kd.LAUNCHES}
    kd.reset_launch_counts()
    seen.clear()
    none = kd.class_deltas(pts, ns, cls, (), parts)
    assert none.shape == (3, 1) and not bool(none.any())
    kd.update(pts, f_n, ns, cls, edge, none, 0.25, CFG.alphas, ("dummy", "edge", "corner"))
    assert dict(seen)["dense_update"][10:14] == (1, 0, None, 0.25)
    assert kd.LAUNCHES == {**NO_LAUNCH, "dense_update": 1}
    kd.reset_launch_counts()


def test_wrappers_reject_other_devices_and_bad_operands(monkeypatch):
    pts, nrm, nf, ns, d = _operands(n=600)
    meta = Neighborhood(nf.idx.to("meta"), nf.mask.to("meta"))
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        kd.vote(pts.to("meta"), nrm.to("meta"), meta, CFG.angle, 0.3, 3.0)
    with pytest.raises(ValueError, match=r"\(rows, 3\)"):
        kd.vote(pts[:, :2], nrm, nf, CFG.angle, 0.3, 3.0)
    with pytest.raises(ValueError, match="rows"):
        kd.vote(pts, nrm[:-1], nf, CFG.angle, 0.3, 3.0)
    with pytest.raises(ValueError, match="rows"):
        kd.vote(pts, nrm, Neighborhood(nf.idx[:-1], nf.mask[:-1]), CFG.angle, 0.3, 3.0)
    with pytest.raises(ValueError, match="the other operands"):
        kd.vote(pts, nrm, meta, CFG.angle, 0.3, 3.0)
    with pytest.raises(ValueError, match="the other operands"):
        kd.vote(pts, nrm, nf, CFG.angle, 0.3, 3.0, src_points=pts.to("meta"))
    cls = torch.zeros(pts.shape[0], dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown step"):
        kd.update(pts, nrm, ns, cls, nrm, torch.zeros((3, 1)), d, CFG.alphas,
                  ("flat", "edge", "sharpen"))

    # The dtypes only the kernels need: the plain versions take float64 on
    # the CPU as the eager stages did.
    wide = kd.vote(pts.double(), nrm.double(), nf, CFG.angle, 0.3, 3.0)
    assert wide.dtype == torch.float64
    assert torch.equal(wide, kd.vote_plain(pts.double(), nrm.double(), nf, CFG.angle, 0.3, 3.0))
    card_nf = Neighborhood(_OnCard(nf.idx), _OnCard(nf.mask))
    with pytest.raises(TypeError, match="float32"):
        kd._on_cuda({"points": _OnCard(pts.double())}, {"nbh": card_nf})
    with pytest.raises(TypeError, match="float32"):
        kd._on_cuda({"points": _OnCard(pts)}, {"nbh": card_nf},
                    {"src_points": _OnCard(pts.double())})
    with pytest.raises(TypeError, match="int64"):
        kd._on_cuda({"points": _OnCard(pts)},
                    {"nbh": Neighborhood(_OnCard(nf.idx.int()), _OnCard(nf.mask))})

    # What only the kernels refuse: the plain functions take these on the CPU.
    monkeypatch.setattr(kw, "launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(kd, "_on_cuda", lambda *a: True)
    with pytest.raises(ValueError, match="cls"):
        kd.class_deltas(pts, ns, cls.long(), (0,), torch.zeros((12, 5)))
    with pytest.raises(ValueError, match="partials"):
        kd.class_deltas(pts, ns, cls, (0,), torch.zeros((12, 2)))
    with pytest.raises(ValueError, match="deltas"):
        kd.update(pts, nrm, ns, cls, nrm, torch.zeros(3), d, CFG.alphas, STRATEGIES[0])
    with pytest.raises(ValueError, match="d must be"):
        kd.update(pts, nrm, ns, cls, nrm, torch.zeros((3, 1)), d.double(), CFG.alphas,
                  STRATEGIES[0])
    with pytest.raises(ValueError, match="delta classes"):
        kd.classify(pts, nrm, nf, CFG.angle, CFG.class_scale, ns, (3,))


def test_strided_and_wide_operands_reach_the_launch(monkeypatch):
    """Strided operands reach a kernel as contiguous copies, and a
    neighbourhood of any width is taken (past MAX_K in the kernels' own
    order)."""
    pts, nrm, _, _, _ = _operands(n=600)
    wide = knn(pts, kd.MAX_K + 9)[0]
    card = Neighborhood(_OnCard(wide.idx), _OnCard(wide.mask))
    assert kd._on_cuda({"points": _OnCard(pts)}, {"nbh": card})
    seen = _recording_launch(monkeypatch)
    strided = torch.cat([pts, nrm], dim=1)
    s_pts, s_nrm = strided[:, :3], strided[:, 3:]
    assert not s_pts.is_contiguous()
    kd.vote(s_pts, s_nrm, Neighborhood(wide.idx.t().contiguous().t(), wide.mask), CFG.angle,
            0.3, 3.0)
    args = dict(seen)["dense_vote"]
    assert args[7] == kd.MAX_K + 9
    assert args[0] != s_pts.data_ptr() and args[1] != s_nrm.data_ptr()


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA dense stage kernels have no CPU mode")
    return torch.device("cuda")


def _hold_iteration(ops, strategy, cfg):
    """One iteration: the kernels against the plain versions on the same
    operands. Returns the eager outputs, the next iteration's inputs."""
    pts, nrm, nf, ns, d = ops
    args = _iteration_args(ops, strategy, cfg)
    want_p, want_f, want_c, edge, eager_d = _plain_iteration(ops, strategy, cfg)
    before = dict(kd.LAUNCHES)
    got_p, got_f, got_c = denoise_iteration(*args)
    torch.cuda.synchronize()
    classes = kd.delta_classes(strategy)
    launched = {k: kd.LAUNCHES[k] - before[k] for k in kd.LAUNCHES}
    assert launched == {**{k: 1 for k in kd.LAUNCHES}, "dense_sums": int(bool(classes)),
                        "dense_delta": int(bool(classes))}
    assert torch.equal(got_f, want_f)
    assert torch.equal(got_c, want_c)

    # The update kernel fed the eager deltas: every position equal.
    cls, got_edge, parts = kd.classify(pts, want_f, nf, cfg.angle, cfg.class_scale, ns, classes)
    assert torch.equal(cls, want_c) and torch.equal(got_edge, edge)
    fed = kd.update(pts, want_f, ns, want_c, edge, eager_d, d, cfg.alphas, strategy)
    assert torch.equal(fed, want_p)

    # The kernels' own deltas and positions.
    own = kd.class_deltas(pts, ns, want_c, classes, parts).amax(dim=1)
    extent = float(pts.abs().max())
    for c in classes:
        assert abs(float(own[c]) - float(eager_d[c, 0])) <= DELTA_TOL * extent, (c, own, eager_d)
    by_delta = torch.zeros_like(want_c, dtype=torch.bool)
    for c in classes:
        by_delta |= want_c == c
    assert torch.equal(got_p[~by_delta], want_p[~by_delta])
    assert float((got_p - want_p).abs().max()) <= POS_TOL * extent
    return want_p.contiguous(), want_f.contiguous()


CARD_CASES = {
    # the cell's cloud and neighbourhoods: roof, 32,768 points, k 32 and 8
    "roof32k": dict(cloud="roof", n=32_768, cfg=DenoiseConfig(feature_k=32, step_k=8)),
    # small and ragged: 4,000 corner points, the last 100 invalid, k 16 and 7
    "corner4000": dict(cloud="corner", n=4_000, cfg=CFG, num_valid=3_900),
    # invalid slots in the rows, one row with none valid
    "corner1500_dropped": dict(cloud="corner", n=1_500, cfg=CFG, drop=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", STRATEGIES, ids="-".join)
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_card_dense_stage_kernels_match_the_eager_stages(cuda_device, case, strategy):
    """Two iterations, each held stage by stage against the plain versions
    on the same operands (the next iteration starts from the eager
    outputs); denoise_iteration launches each kernel once, the sums' and
    deltas' only where flat or new is in the strategy."""
    spec = dict(CARD_CASES[case])
    cfg = spec.pop("cfg")
    cloud = spec.pop("cloud")
    n = spec.pop("n")
    if cloud == "roof":
        noisy, nrm, _ = make_cloud(n)
        pts, nrm = torch.as_tensor(noisy).to(cuda_device), torch.as_tensor(nrm).to(cuda_device)
        d = cfg.d_scale / 2.0 * step_threshold(pts)
    else:
        pts, nrm, _, _, d = _operands(n, cfg, device=cuda_device, **spec)
    kd.reset_launch_counts()
    for _ in range(2):
        nf = knn(pts, cfg.feature_k, num_valid=spec.get("num_valid"))[0]
        ns = knn(pts, cfg.step_k, num_valid=spec.get("num_valid"))[0]
        if spec.get("drop"):
            nf, ns = (Neighborhood(nb.idx, _dropped(nb.mask)) for nb in (nf, ns))
        pts, nrm = _hold_iteration((pts, nrm, nf, ns, d), strategy, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", [("flat", "edge", "new"), ("corner", "feature", "new")],
                         ids="-".join)
def test_card_dense_stage_kernels_past_max_k(cuda_device, strategy):
    """Feature and step neighbourhoods wider than MAX_K (136 and 130 slots
    on 3,000 corner points): each stage, fed the plain outputs before it,
    within its rounding of the plain version (WIDE_*, POS_TOL and
    DELTA_TOL of the extent)."""
    cfg = DenoiseConfig(feature_k=kd.MAX_K + 9, step_k=kd.MAX_K + 3)
    ops = pts, nrm, nf, ns, d = _operands(3_000, cfg, device=cuda_device)
    want_p, want_f, want_c, edge, eager_d = _plain_iteration(ops, strategy, cfg)
    classes = kd.delta_classes(strategy)
    extent = float(pts.abs().max())
    got_f = kd.vote(pts, nrm, nf, cfg.angle, cfg.vu_tau, cfg.vu_damping)
    assert float((got_f - want_f).abs().max()) <= WIDE_NORMAL_TOL
    cls, got_edge, parts = kd.classify(pts, want_f, nf, cfg.angle, cfg.class_scale, ns, classes)
    assert float((cls == want_c).float().mean()) >= WIDE_CLASS_SHARE
    fed = kd.update(pts, want_f, ns, want_c, edge, eager_d, d, cfg.alphas, strategy)
    assert float((fed - want_p).abs().max()) <= POS_TOL * extent
    own = kd.class_deltas(pts, ns, want_c, classes, parts).amax(dim=1)
    for c in classes:
        assert abs(float(own[c]) - float(eager_d[c, 0])) <= DELTA_TOL * extent


@pytest.mark.cuda
def test_card_denoise_runs_each_dense_kernel_once_an_iteration(cuda_device):
    """pipeline.denoise (the cell's path) and the until-min loop (the
    CLI's --until-min) take the kernels on every iteration; strided
    operands give the contiguous ones' result."""
    noisy, nrm, clean = make_cloud(32_768)
    cfg = DenoiseConfig(feature_k=32, step_k=8)
    kd.reset_launch_counts()
    out, out_n, cls = denoise(noisy, nrm, cfg, iterations=2, neighbor_method="brute",
                              device=cuda_device)
    torch.cuda.synchronize()
    assert kd.LAUNCHES == {name: 2 for name in kd.LAUNCHES}
    assert bool(torch.isfinite(out).all()) and cls.dtype == torch.int32
    kd.reset_launch_counts()
    _, _, _, done = pipeline.denoise_until_minimum_error(
        noisy, nrm, clean, cfg, max_iterations=3, device=cuda_device)
    runs = min(done + 1, 3)
    assert kd.LAUNCHES == {name: runs for name in kd.LAUNCHES}
    assert np.isfinite(done)

    ops = _operands(2_000, cfg, device=cuda_device)
    pts, nrm_t = ops[0], ops[1]
    both = torch.cat([pts, nrm_t], dim=1)
    strided = (both[:, :3], both[:, 3:], *ops[2:])
    assert not strided[0].is_contiguous()
    want = denoise_iteration(*_iteration_args(ops, pipeline.DEFAULT_STRATEGY, cfg))
    got = denoise_iteration(*_iteration_args(strided, pipeline.DEFAULT_STRATEGY, cfg))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
