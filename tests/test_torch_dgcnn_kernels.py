"""The contract the learned models' graph kernels
(``ngpd_tpu_torch/kernels/csrc/feature_knn.cu``, ``edge_block.cu``,
``dgcnn_epilogue.cu``) have to meet, pinned where no card exists.

On CUDA tensors ``models/dgcnn.py::feature_knn`` and
``models/edge.py::edge_block`` launch the kernels; on CPU tensors they run
the plain versions, ``feature_knn_plain`` and ``edge_block_plain``, which
the card tests and ``chip_smoke.py`` hold the kernels to. Here the plain
versions are held to ``ngpd_tpu``: the feature kNN equal, ties included, on
small-integer features with repeated rows, and equal on every clearly
separated row of real patch features and activations; the edge blocks of
the DGCNN and of EdgeConv equal bit for bit. The edge block's backward is
the gradient of the plain expression, bit for bit in float64. The
epilogue's plain version, ``models/dgcnn.py::dgcnn_epilogue_plain``, is the
BatchNorm, LeakyReLU and max over neighbours that the DGCNN ran before it,
bit for bit, and only an eval-mode forward that takes no gradient routes
through ``dgcnn_epilogue``. ``chip_smoke``'s ``dgcnn_kernels`` check must
refuse a kNN that breaks ties by the higher index, one that drops self, an
edge block with its halves swapped, an epilogue that drops NaN and one with
another slope.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import chip_smoke as cs
from ngpd_tpu.meshproc.patches import extract_mesh_patches
from ngpd_tpu.meshproc.synthetic import icosphere
from ngpd_tpu.meshproc.trimesh import add_mesh_noise
from ngpd_tpu.models import dgcnn as jdg
from ngpd_tpu.models import edgeconv as jec
from ngpd_tpu_torch.kernels import build
from ngpd_tpu_torch.kernels import graph as kgraph
from ngpd_tpu_torch.learn import weights as tw
from ngpd_tpu_torch.models import dgcnn as tdg
from ngpd_tpu_torch.models import edge as tedge

torch.set_num_threads(2)

K = 8
SEPARATION = 2 * 2.0 ** -24  # times C times the larger distance: two summation orders


def _int_features(b, p, c, seed):
    """Features 0, 1 or 2; the last 24 rows of each patch equal."""
    x = np.random.default_rng(seed).integers(0, 3, size=(b, p, c)).astype(np.float32)
    x[:, p - 24:] = 0.0
    return x


@pytest.mark.parametrize("c", [17, 128, 256])
def test_plain_feature_knn_equals_the_reference_ties_included(c):
    x = _int_features(6, 64, c, seed=c)
    want = np.asarray(jdg.feature_knn(jnp.asarray(x), K))
    np.testing.assert_array_equal(tdg.feature_knn_plain(torch.as_tensor(x), K).numpy(), want)
    # The repeated rows tie at every distance: the cases hold ties.
    assert (want[:, 40:, 1] < want[:, 40:, 2]).all()


@pytest.fixture(scope="module")
def patch_features():
    """The 17 input features of 96 patches of a noisy icosphere(2) and the
    activations that feed the port's conv4-conv6 with the committed
    weights."""
    noisy = add_mesh_noise(icosphere(subdiv=2), jax.random.PRNGKey(0), 0.3)
    inputs = torch.as_tensor(np.array(extract_mesh_patches(noisy).inputs[:96]))
    model = tdg.dgcnn_from_state_dict(tw.load_dgcnn_state_dict(cs.bench.ASSETS /
                                                               "dgcnn_mesh.npz"))
    seen, knn = [inputs[:, :17].transpose(1, 2).contiguous()], tdg.feature_knn

    def capture(x, k):
        seen.append(x.clone())
        return knn(x, k)

    tdg.feature_knn = capture
    try:
        with torch.no_grad():
            model(inputs)
    finally:
        tdg.feature_knn = knn
    return seen


@pytest.mark.parametrize("which", [0, 1, 2, 3], ids=["input17", "conv4", "conv5", "conv6"])
def test_plain_feature_knn_matches_the_reference_on_real_features(patch_features, which):
    """Equal on every row whose first k + 1 sorted distances keep each gap
    above 2 C 2^-24 times the larger one (XLA and torch sum in other
    orders); most rows are such rows."""
    x = patch_features[which]
    c = x.shape[2]
    got = tdg.feature_knn_plain(x, K).numpy()
    want = np.asarray(jdg.feature_knn(jnp.asarray(x.numpy()), K))
    s = np.sort(tdg.feature_sqdist(x).numpy(), axis=-1)[..., : K + 1]
    clear = ((s[..., 1:] - s[..., :-1]) > SEPARATION * c * s[..., 1:]).all(axis=-1)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], want[clear])


def _ref_edgeconv_features(x, idx, dynamic=False):
    """The block that ngpd_tpu's EdgeConv (or DynamicEdgeConv) feeds its
    Dense layer, captured at the Dense's input."""
    b, p, f = x.shape
    seen = []

    def capture(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dense) and context.method_name == "__call__":
            seen.append(np.asarray(args[0]))
        return next_fun(*args, **kwargs)

    if dynamic:
        mod = jec.DynamicEdgeConv(features=4, k=idx.shape[2], train=False)
        args = (jnp.asarray(x), jnp.ones((b, p), bool))
    else:
        mod = jec.EdgeConv(features=4, train=False)
        args = (jnp.asarray(x), jnp.asarray(idx), jnp.ones(idx.shape, bool),
                jnp.ones((b, p), bool))
    variables = mod.init(jax.random.PRNGKey(0), *args)
    with fnn.intercept_methods(capture):
        mod.apply(variables, *args)
    return seen[-1]


@pytest.mark.parametrize("k", [3, 8, 12])
def test_plain_edge_block_equals_the_reference(k):
    """Both orders, bit for bit: the DGCNN's ``_edge_features`` and
    EdgeConv's concatenation (at the input of its Dense layer)."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(5, 64, 17)).astype(np.float32)
    idx = rng.integers(0, 64, size=(5, 64, k))
    tx, tidx = torch.as_tensor(x), torch.as_tensor(idx)
    want = np.asarray(jdg._edge_features(jnp.asarray(x), jnp.asarray(idx)))
    np.testing.assert_array_equal(tedge.edge_block_plain(tx, tidx, "dgcnn").numpy(), want)
    np.testing.assert_array_equal(tdg._edge_features(tx, tidx).numpy(), want)
    want = _ref_edgeconv_features(x, idx)
    np.testing.assert_array_equal(tedge.edge_block_plain(tx, tidx, "edgeconv").numpy(), want)
    np.testing.assert_array_equal(tedge.edge_block(tx, tidx, "edgeconv").numpy(), want)


def test_dynamic_edgeconv_block_equals_the_reference():
    """DynamicEdgeConv's block over its own masked kNN, self excluded."""
    from ngpd_tpu_torch.core.patches import masked_pair_knn

    x = np.random.default_rng(7).normal(size=(3, 64, 16)).astype(np.float32)
    idx, _ = masked_pair_knn(torch.as_tensor(x), torch.ones((3, 64), dtype=torch.bool), K)
    want = _ref_edgeconv_features(x, idx.numpy(), dynamic=True)
    np.testing.assert_array_equal(tedge.edge_block(torch.as_tensor(x), idx, "edgeconv").numpy(),
                                  want)


@pytest.mark.parametrize("order", ["dgcnn", "edgeconv"])
def test_edge_block_gradient_is_the_plain_expressions(order):
    """The autograd.Function's gradient to x equals autograd's of the plain
    expression bit for bit in float64 (repeated and negative indices
    included), and passes gradcheck."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, 20, 6), generator=g, dtype=torch.float64)
    idx = torch.randint(0, 20, (3, 20, 5), generator=g)
    idx[0, 0] = torch.tensor([-1, 3, 3, 0, -20])
    w = torch.randn((3, 20, 5, 12), generator=g, dtype=torch.float64)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    (tedge.edge_block(a, idx, order) * w).sum().backward()
    (tedge.edge_block_plain(b, idx, order) * w).sum().backward()
    assert torch.equal(a.grad, b.grad)
    small = torch.randn((2, 6, 3), generator=g, dtype=torch.float64, requires_grad=True)
    sidx = torch.randint(0, 6, (2, 6, 4), generator=g)
    assert torch.autograd.gradcheck(lambda t: tedge.edge_block(t, sidx, order), (small,))


def test_edge_block_takes_a_non_contiguous_view_without_a_gradient():
    """The DGCNN's first conv takes x and idx as transposed views of its
    inputs, which need no gradient."""
    inputs = torch.randn((4, 20, 64))
    inputs[:, 17:] = torch.randint(0, 64, (4, 3, 64)).float()
    x = inputs[:, :17].transpose(1, 2)
    idx = inputs[:, 17:].to(torch.int64).transpose(1, 2)
    out = tdg._edge_features(x, idx)
    assert not out.requires_grad
    assert torch.equal(out, tedge.edge_block_plain(x.contiguous(), idx.contiguous(), "dgcnn"))


def _launch_params(name):
    src = (build.CSRC / f"{name}.cu").read_text()
    sig = src[src.index(f'extern "C" int ngpd_{name}_launch('):]
    return src, sig[sig.index("(") + 1 : sig.index(")")].split(",")


@pytest.mark.parametrize("name", ["feature_knn", "edge_block", "dgcnn_epilogue"])
def test_the_launch_arguments_match_the_kernel_source(name):
    """One ctypes type per parameter of the launch function; the limits and
    variants the wrapper names are the source's; the note says why no
    tensor core is used and what it replaces."""
    src, params = _launch_params(name)
    assert len(params) == len(build.ARGTYPES[name])
    for text, ctype in zip(params, build.ARGTYPES[name]):
        want = build._VP if "*" in text else build._F if "float" in text else build._I
        assert ctype is want, text
    assert f'extern "C" int ngpd_{name}_blocks_per_sm(' in src
    assert "Replaces: ngpd_tpu/models/dgcnn.py" in src and "What bounds it on the H100" in src
    assert "cudaGetLastError" in src and "__fsub_rn" in src
    if name == "feature_knn":
        assert f"FKNN_MAX_P = {kgraph.FEATURE_KNN_MAX_P};" in src
        assert f"FKNN_MAX_K = {kgraph.FEATURE_KNN_MAX_K};" in src
        for const, value in (("SLAB", kgraph.FEATURE_KNN_SLAB),
                             ("STAGES", kgraph.FEATURE_KNN_STAGES),
                             ("COLS", kgraph.FEATURE_KNN_COLS), ("ROWS", kgraph.FEATURE_KNN_ROWS),
                             ("WARPS", kgraph.FEATURE_KNN_WARPS)):
            assert f"FKNN_{const} = {value};" in src, const
        assert "FKNN_PITCH = FKNN_SLAB + 4;" in src
        assert kgraph.FEATURE_KNN_PITCH == kgraph.FEATURE_KNN_SLAB + 4
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src and "cp.async" in src
        for word in ("mma", "wgmma", "TF32", "__fmul_rn", "__fadd_rn"):
            assert word in src
        launched = set(re.findall(r"fn\(feature_knn_kernel<(\d+), (\w+), (\w+)>\)", src))
        assert launched == {(k, v, o) for k in ("8", "16") for v in ("true", "false")
                            for o in ("true", "false")}
        assert [kgraph.feature_knn_variant(k) for k in (1, 8, 9, 16)] == [8, 8, 16, 16]
    elif name == "edge_block":
        assert "edgeconv.py" in src
        assert sorted(re.findall(r"edge_block_kernel<(\w+)><<<", src)) == ["false", "true"]
        assert kgraph.EDGE_ORDERS == {"dgcnn": 0, "edgeconv": 1}
    else:
        # K 1, 3 and 8 built as templates, any other K read at run time;
        # float4 and one-channel kernels; torch's slope and NaN-keeping max.
        launched = re.findall(r"case (\d+): return ep_launch<(\d+), W>", src)
        assert [(int(a), int(b)) for a, b in launched] == [(k, k) for k in
                                                          kgraph.DGCNN_EPILOGUE_KS]
        assert "default: return ep_launch<0, W>" in src
        assert "ep_dispatch<4>" in src and "ep_dispatch<1>" in src
        assert [kgraph.dgcnn_epilogue_variant(k) for k in (1, 3, 5, 8, 16)] == [1, 3, 0, 8, 0]
        assert f"EP_SLOPE = {tdg.LEAKY_SLOPE}f;" in src
        for word in ("__fmul_rn", "__fadd_rn", "__ldcs", "__stcs", "isnan(a)", "l.54-57"):
            assert word in src
        assert "fmaxf(" not in src and "__fmaf" not in src


# (P, warps, rounds, shared-memory bytes) of the feature kNN's layout: a warp
# owns 64 rows and 8 columns a round, at most 8 warps a block; the block's
# shared memory is the larger of the slab ring (3 x rows x 36 floats) and a
# round's keys (rows x columns x 8 bytes), whatever C.
FKNN_SHAPES = [(1, 1, 1, 27_648), (16, 2, 1, 27_648), (37, 5, 1, 27_648), (64, 8, 1, 32_768),
               (65, 8, 3, 55_296), (129, 6, 9, 82_944), (200, 8, 13, 110_592),
               (256, 8, 16, 110_592)]


@pytest.mark.parametrize("p,warps,rounds,smem", FKNN_SHAPES,
                         ids=[f"P{p}" for p, *_ in FKNN_SHAPES])
def test_the_feature_knn_layout_is_pinned(p, warps, rounds, smem):
    """What kernels/graph.py computes of a launch (FknnShape,
    fknn_smem_bytes): threads, rounds and shared memory by P alone, so C
    sets no limit; every node has a selecting thread; at the mesh cell's P
    64 one round of 8 warps in 32 KB."""
    shape = kgraph.feature_knn_shape(p)
    assert (shape["warps"], shape["rounds"], kgraph.feature_knn_smem_bytes(p)) == \
        (warps, rounds, smem)
    assert shape["threads"] == 32 * warps >= p
    assert smem <= 232_448  # an H100 block's shared memory
    # Every round's columns lie inside the staged rows.
    assert shape["rounds"] * shape["groups"] * kgraph.FEATURE_KNN_COLS <= shape["rows"]


def _small_check(**kwargs):
    return cs.check_dgcnn_kernels(device="cpu", mesh_subdiv=1, mesh_batch=32,
                                  point_batch=4, **kwargs)


def test_the_smoke_check_passes_the_plain_versions():
    rec = _small_check()
    fk, eb = rec["feature_knn"], rec["edge_block"]
    assert [r["c"] for r in fk] == [128, 256, 128, 256, 256]
    assert all(r.get("equal", True) and r["max_abs_err"] == 0.0 for r in fk)
    assert all(r["differing_clear_rows"] == 0 and r["rows"] == 32 * 64 for r in fk[2:])
    shapes = [(r["model"], r["c"], r["k"], r["order"]) for r in eb]
    assert shapes == [("dgcnn", 17, 3, "dgcnn"), ("dgcnn", 64, 3, "dgcnn"),
                      ("dgcnn", 128, 8, "dgcnn"), ("dgcnn", 256, 8, "dgcnn"),
                      ("patch2normal", 8, 12, "edgeconv"), ("patch2normal", 64, 12, "edgeconv"),
                      ("patch2normal", 128, 12, "edgeconv"),
                      ("patch2normal", 256, 12, "edgeconv")]
    assert all(r["equal"] for r in eb)
    ep = rec["dgcnn_epilogue"]
    assert [(r["layer"], r["k"], r["c"]) for r in ep] == [
        ("conv1", 3, 64), ("conv2", 3, 64), ("conv3", 3, 128), ("conv4", 8, 256),
        ("conv5", 8, 256), ("conv6", 8, 256), ("conv7", 1, 1024)]
    assert all(r["equal"] and r["bits_equal"] and r["specials_equal"] and r["nan_outputs"] > 0
               and r["batch"] == 32 for r in ep)


def _higher_index_ties(x, k):
    """A feature kNN whose equal distances keep the higher index."""
    p = x.shape[1]
    return p - 1 - tdg.feature_knn_plain(torch.flip(x, [1]), k)


def _drops_self(x, k):
    """A feature kNN that leaves each node out of its own list."""
    d = tdg.feature_sqdist(x)
    d = d + torch.diag(torch.full((x.shape[1],), float("inf")))
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def _halves_swapped(x, idx, order):
    return tedge.edge_block_plain(x, idx, "edgeconv" if order == "dgcnn" else "dgcnn")


def _nan_dropped(h, mean, mul, bias, k):
    """An epilogue whose max passes over NaN, as fmaxf does."""
    y = tdg._act((h - mean) * mul + bias).nan_to_num(nan=float("-inf"))
    return torch.amax(y, dim=-2) if k > 1 else y


def _other_slope(h, mean, mul, bias, k):
    y = torch.nn.functional.leaky_relu((h - mean) * mul + bias, 0.1)
    return torch.amax(y, dim=-2) if k > 1 else y


@pytest.mark.parametrize("wrong", [{"knn_fn": _higher_index_ties}, {"knn_fn": _drops_self},
                                   {"edge_fn": _halves_swapped}, {"epilogue_fn": _nan_dropped},
                                   {"epilogue_fn": _other_slope}],
                         ids=["higher_index_ties", "drops_self", "halves_swapped",
                              "nan_dropped", "other_slope"])
def test_the_smoke_check_refuses_a_wrong_kernel(wrong):
    with pytest.raises(SystemExit):
        _small_check(**wrong)



EPILOGUE_KS, EPILOGUE_CS = (1, 3, 8), (64, 128, 256, 1024)


def _drawn_bn(c, seed):
    """A DGCNN BatchNorm in eval mode with drawn statistics and terms (the
    scale of both signs)."""
    g = torch.Generator().manual_seed(seed)
    bn = torch.nn.BatchNorm2d(c, eps=tdg.BN_EPS)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) * 2.0 + 0.05)
        bn.weight.copy_(torch.randn(c, generator=g))
        bn.bias.copy_(torch.randn(c, generator=g))
    return bn.eval()


def _planted_products(k, c, seed):
    """(3, 16, k, c) products (at k 1 (3, 16, c)) with NaN, +-inf and
    zeros of both signs planted."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn((3, 16, k, c) if k > 1 else (3, 16, c), generator=g) * 3.0
    flat = h.view(-1)
    for value in (float("nan"), float("inf"), float("-inf"), 0.0, -0.0):
        flat[torch.randint(0, flat.numel(), (40,), generator=g)] = value
    return h


def _assert_same_bits(got, want):
    """NaN at the same places and every other output equal bit for bit."""
    nan = torch.isnan(want)
    assert nan.any() and torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.parametrize("c", EPILOGUE_CS)
@pytest.mark.parametrize("k", EPILOGUE_KS)
def test_plain_epilogue_is_the_old_expression_bit_for_bit(k, c):
    """``dgcnn_epilogue_plain`` (and ``dgcnn_epilogue`` on the CPU) with
    ``_bn_terms``' mean and multiplier is ``_bn`` -> ``_act`` -> ``amax``
    over the neighbours (at k 1 without the max), as the DGCNN ran it."""
    bn = _drawn_bn(c, seed=c + k)
    h = _planted_products(k, c, seed=c * k)
    with torch.no_grad():
        y = tdg._act(tdg._bn(h, bn))
        old = torch.amax(y, dim=2) if k > 1 else y
        mean, mul = tdg._bn_terms(h, bn)
        for fn in (tdg.dgcnn_epilogue_plain, tdg.dgcnn_epilogue):
            _assert_same_bits(fn(h, mean, mul, bn.bias, k), old)


def _forward_written_out(model, inputs):
    """The DGCNN's eval forward as it ran before the epilogue: each
    BatchNorm, LeakyReLU and max over neighbours an expression of its own."""
    x = inputs[:, :17].transpose(1, 2).contiguous()
    idx = inputs[:, 17:20].to(torch.int64).transpose(1, 2).contiguous()
    outs = []
    for i in range(1, 7):
        nbr = idx if i <= tdg.NUM_FIXED else tdg.feature_knn_plain(x, model.k)
        h = tedge.edge_block_plain(x, nbr, "dgcnn") @ getattr(model, f"conv{i}")[0].weight[
            :, :, 0, 0].T
        x = torch.amax(tdg._act(tdg._bn(h, getattr(model, f"bn{i}"))), dim=2)
        outs.append(x)
    h = tdg._act(tdg._bn(torch.cat(outs, dim=-1) @ model.conv7[0].weight[:, :, 0].T, model.bn7))
    h = torch.cat([torch.amax(h, dim=1), torch.mean(h, dim=1)], dim=-1)
    h = tdg._act(tdg._bn(h @ model.linear1.weight.T, model.bn8))
    h = tdg._act(tdg._bn(model.linear2(h), model.bn9))
    h = tdg._act(tdg._bn(model.linear3(h), model.bn10))
    return model.linear4(h)


def _patch_inputs(b, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.cat([torch.randn((b, 17, 64), generator=g),
                      torch.randint(0, 64, (b, 3, 64), generator=g).float()], dim=1)


@pytest.mark.parametrize("weights", ["dgcnn_mesh.npz", "dgcnn_mesh_2.npz", "seeded_k1"])
def test_an_eval_forward_is_the_expression_written_out(weights):
    """With the committed weights (and with seeded ones at a feature kNN
    of k 1, whose convs have a neighbour axis of one) an eval-mode forward
    equals the forward written out with the old expressions,
    ``torch.equal``."""
    if weights == "seeded_k1":
        torch.manual_seed(0)
        model = tdg.DGCNN(k=1, emb_dims=64).eval()
    else:
        model = tdg.dgcnn_from_state_dict(tw.load_dgcnn_state_dict(cs.bench.ASSETS / weights))
    inputs = _patch_inputs(6, seed=len(weights))
    with torch.no_grad():
        got = model(inputs)
        want = _forward_written_out(model, inputs)
    assert torch.equal(got, want)


ROUTES = {"eval_no_grad": [3, 3, 3, 8, 8, 8, 1], "eval_frozen": [3, 3, 3, 8, 8, 8, 1],
          "eval_grad": [], "eval_input_grad": [], "train": [], "train_no_grad": []}


@pytest.mark.parametrize("route", list(ROUTES))
def test_only_a_forward_without_a_gradient_takes_the_epilogue(monkeypatch, route):
    """An eval-mode forward that takes no gradient (under no_grad, or with
    nothing that requires one) calls ``dgcnn_epilogue`` seven times, at
    the convs' K and conv7's 1; one whose parameters or input require a
    gradient, and every train-mode forward, never call it. No launch is
    counted."""
    calls = []

    def counting(h, mean, mul, bias, k):
        calls.append(k)
        return tdg.dgcnn_epilogue_plain(h, mean, mul, bias, k)

    monkeypatch.setattr(tdg, "dgcnn_epilogue", counting)
    before = dict(kgraph.LAUNCHES)
    model = tdg.DGCNN(emb_dims=64)
    inputs = _patch_inputs(4, seed=3)
    if route.startswith("train"):
        keep = model.draw_keep_masks(4, torch.Generator().manual_seed(0))
        with torch.set_grad_enabled(route == "train"):
            model.train()(inputs, keep=keep)
    else:
        model.eval()
        if route == "eval_frozen":
            model.requires_grad_(False)
        if route == "eval_input_grad":
            model.requires_grad_(False)
            inputs.requires_grad_()
        with torch.set_grad_enabled(route != "eval_no_grad"):
            out = model(inputs)
        if route in ("eval_grad", "eval_input_grad"):
            out.sum().backward()
    assert calls == ROUTES[route]
    assert kgraph.LAUNCHES == before and before["dgcnn_epilogue"] == 0


def test_reset_launch_counts_clears_the_epilogue(monkeypatch):
    monkeypatch.setitem(kgraph.LAUNCHES, "dgcnn_epilogue", 560)
    kgraph.reset_launch_counts()
    assert kgraph.LAUNCHES == {"feature_knn": 0, "edge_block": 0, "dgcnn_epilogue": 0}


class _OnCard:
    """A tensor that reports a CUDA device, for the checks alone."""

    def __init__(self, t, device="cuda"):
        self.t, self.device = t, torch.device(device)
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self.t.dim()

    def is_contiguous(self):
        return self.t.is_contiguous()

    def numel(self):
        return self.t.numel()


def _epilogue_operands(k=8, c=64):
    h = torch.zeros((2, 16, k, c) if k > 1 else (2, 16, c))
    return h, torch.zeros(c), torch.ones(c), torch.zeros(c)


EPILOGUE_REFUSALS = {
    "double_h": (lambda h, m, s, b: (h.double(), m, s, b), 8, TypeError),
    "flat_h": (lambda h, m, s, b: (h[0, 0], m, s, b), 8, TypeError),
    "k_not_the_axis": (lambda h, m, s, b: (h, m, s, b), 3, ValueError),
    "k_zero": (lambda h, m, s, b: (h, m, s, b), 0, ValueError),
    "mean_too_wide": (lambda h, m, s, b: (h, torch.zeros(65), s, b), 8, TypeError),
    "double_mul": (lambda h, m, s, b: (h, m, s.double(), b), 8, TypeError),
    "h_transposed": (lambda h, m, s, b: (h.transpose(0, 1), m, s, b), 8, ValueError),
    "bias_strided": (lambda h, m, s, b: (h, m, s, torch.zeros(128)[::2]), 8, ValueError),
}


@pytest.mark.parametrize("case", list(EPILOGUE_REFUSALS))
def test_the_epilogue_check_refuses_what_the_kernel_does_not_take(case):
    """On a CUDA device the check raises on any operand the kernel does not
    take: another type, rank, k or width, a strided operand."""
    change, k, error = EPILOGUE_REFUSALS[case]
    ops = [_OnCard(t) for t in change(*_epilogue_operands())]
    with pytest.raises(error):
        kgraph.check_dgcnn_epilogue(*ops, k)


def test_the_epilogue_check_takes_the_models_operands_and_tells_the_devices():
    """The card's operands at K 8 and at conv7's K 1 reach the kernel, CPU
    tensors the plain version; terms on another device and devices other
    than cuda or cpu are refused."""
    for k in (8, 1):
        assert kgraph.check_dgcnn_epilogue(*(_OnCard(t) for t in _epilogue_operands(k)), k)
        assert not kgraph.check_dgcnn_epilogue(*_epilogue_operands(k), k)
    h, m, s, b = _epilogue_operands()
    with pytest.raises(ValueError, match="mean on"):
        kgraph.check_dgcnn_epilogue(_OnCard(h), m, _OnCard(s), _OnCard(b), 8)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        kgraph.check_dgcnn_epilogue(*(t.to("meta") for t in (h, m, s, b)), 8)
