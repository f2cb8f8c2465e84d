"""The Patch2Normal model of the port (``models/edgeconv.py``,
``models/patch2normal.py``) and its weights (``learn/weights.py``) against
ngpd_tpu on the CPU, on identical inputs.

Weights come from the reference's ``init_model`` and are carried across
with ``patch2normal_state_dict_from_variables``; the BatchNorm statistics
and affine parameters, and the Dense biases, are then randomised, since a
carry that swapped mean and variance, or scale and bias, would pass on a
fresh initialisation (mean 0, variance 1, scale 1, bias 0).

Tolerances: raw outputs within 2e-4 absolute, the bound the DGCNN forward
is held to (tests/test_torch_dgcnn.py: float32 products summed in another
order by another BLAS); one ``MaskedBatchNorm`` in train mode, its output
and its updated statistics, within 1e-5; the whole model's updated
``batch_stats`` in train mode within 1e-5 of max(|entry|, 1).
``DynamicEdgeConv`` is held on small-integer features, whose distances are
exact and tie: the lower index must come first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngpd_tpu.config import ModelConfig as JModelConfig
from ngpd_tpu.config import PatchConfig as JPatchConfig
from ngpd_tpu.config import TrainConfig as JTrainConfig
from ngpd_tpu.core import patches as jpatches
from ngpd_tpu.learn.train import init_model
from ngpd_tpu.learn.weights import flatten_variables, load_dgcnn_npz, unflatten_variables
from ngpd_tpu.models import edgeconv as jedge
from ngpd_tpu_torch.config import ModelConfig
from ngpd_tpu_torch.learn.weights import (patch2normal_state_dict_from_variables,
                                          save_variables_npz,
                                          variables_from_patch2normal_state_dict)
from ngpd_tpu_torch.models import edgeconv as tedge
from ngpd_tpu_torch.models.patch2normal import Patch2NormalModel, init_patch2normal

from fixtures import sphere_cloud

torch.set_num_threads(2)

NARROW = dict(hidden=(16, 16, 32, 32, 32, 32, 64, 32, 16), patch_size=32, patch_k=8)
OUT_TOL = 2e-4


def _patch_inputs(n_points, num_nodes, patch_k, take):
    """The reference's patches of a noisy sphere, as numpy."""
    pts, nrm = sphere_cloud(n_points, seed=2)
    pts = pts + np.random.default_rng(5).normal(scale=0.01, size=pts.shape).astype(np.float32)
    b = jpatches.extract_patches(jnp.asarray(pts), jnp.asarray(nrm),
                                 cfg=JPatchConfig(num_nodes=num_nodes, patch_k=patch_k))
    return tuple(np.asarray(a)[:take] for a in (b.x, b.nbr_idx, b.nbr_mask, b.node_mask))


def _randomised(variables, seed=0):
    """BN statistics and affine parameters and the Dense biases drawn at
    random, as numpy."""
    rng = np.random.default_rng(seed)
    flat = flatten_variables(variables)
    for key, v in flat.items():
        leaf = key.rsplit("/", 1)[1]
        if leaf == "scale":
            flat[key] = rng.uniform(0.5, 1.5, v.shape)
        elif leaf in ("bias", "mean"):
            flat[key] = rng.normal(0.0, 0.3, v.shape)
        elif leaf == "var":
            flat[key] = rng.uniform(0.5, 2.0, v.shape)
        flat[key] = np.asarray(flat[key], np.float32)
    return unflatten_variables(flat)


def _models(cfg_kwargs, seed=0):
    jm, st, _ = init_model(JModelConfig(**cfg_kwargs), JTrainConfig(), jax.random.PRNGKey(seed))
    variables = _randomised({"params": st.params, "batch_stats": st.batch_stats}, seed)
    tm = Patch2NormalModel(ModelConfig(**cfg_kwargs))
    tm.load_state_dict(patch2normal_state_dict_from_variables(variables), strict=True)
    return jm, variables, tm.eval()


def _j(a):
    return tuple(jnp.asarray(x) for x in a)


def _t(a):
    return tuple(torch.as_tensor(x) for x in a)


@pytest.fixture(scope="module")
def narrow():
    inputs = _patch_inputs(300, 32, 8, 96)
    jm, variables, tm = _models(NARROW)
    return inputs, jm, variables, tm


def test_carry_maps_every_variable_both_ways(narrow):
    _, _, variables, tm = narrow
    sd = patch2normal_state_dict_from_variables(variables)
    assert set(sd) == set(tm.state_dict())
    back = flatten_variables(variables_from_patch2normal_state_dict(tm.state_dict()))
    want = flatten_variables(variables)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    # The randomised state is not a fresh initialisation.
    assert not torch.allclose(tm.layer0.bn.running_var, torch.ones(16))
    assert not torch.allclose(tm.layer0.bn.weight, torch.ones(16))


def test_eval_forward_matches(narrow):
    inputs, jm, variables, tm = narrow
    want = np.asarray(jm.apply(variables, *_j(inputs), train=False))
    with torch.no_grad():
        got = tm(*_t(inputs)).numpy()
    assert np.abs(got - want).max() <= OUT_TOL, np.abs(got - want).max()
    assert np.abs(want).max() > 0.1  # the outputs are not all near zero
    pj = np.asarray(jm.predict(variables, *_j(inputs)))
    pt = tm.predict(*_t(inputs)).numpy()
    np.testing.assert_allclose(pt, pj, atol=OUT_TOL)
    np.testing.assert_allclose(np.linalg.norm(pt, axis=1), 1.0, atol=1e-6)


def test_full_width_forward_matches():
    """ModelConfig's defaults (64 nodes, 12 neighbours, hidden up to 512)
    on 40 patches."""
    inputs = _patch_inputs(200, 64, 12, 40)
    jm, variables, tm = _models({}, seed=1)
    want = np.asarray(jm.apply(variables, *_j(inputs), train=False))
    with torch.no_grad():
        got = tm(*_t(inputs)).numpy()
    assert np.abs(got - want).max() <= OUT_TOL, np.abs(got - want).max()


def test_train_mode_updates_batch_stats_like_flax(narrow):
    inputs, _, _, _ = narrow
    cfg = dict(NARROW, dropout_rate=0.0)
    jm, variables, tm = _models(cfg, seed=3)
    want, upd = jm.apply(variables, *_j(inputs), train=True, mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        got = tm(*_t(inputs)).numpy()
    tm.eval()
    assert np.abs(got - np.asarray(want)).max() <= OUT_TOL
    new = flatten_variables(variables_from_patch2normal_state_dict(tm.state_dict()))
    old = flatten_variables(variables)
    for key, v in flatten_variables({"batch_stats": upd["batch_stats"]}).items():
        v = np.asarray(v)
        assert not np.array_equal(v, old[key]), key
        assert (np.abs(new[key] - v) / np.maximum(np.abs(v), 1.0)).max() <= 1e-5, key


@pytest.mark.parametrize("train", [False, True])
def test_masked_batch_norm_matches(train):
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, (6, 10, 5)).astype(np.float32)
    mask = rng.random((6, 10)) < 0.7
    bn = jedge.MaskedBatchNorm(use_running_average=not train)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
                            "bias": rng.normal(0, 0.3, 5).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(0, 0.3, 5).astype(np.float32),
                                 "var": rng.uniform(0.5, 2, 5).astype(np.float32)}}
    want, upd = bn.apply(variables, jnp.asarray(x), jnp.asarray(mask), mutable=["batch_stats"])
    tb = tedge.MaskedBatchNorm(5)
    tb.load_state_dict({"weight": torch.as_tensor(variables["params"]["scale"]),
                        "bias": torch.as_tensor(variables["params"]["bias"]),
                        "running_mean": torch.as_tensor(variables["batch_stats"]["mean"]),
                        "running_var": torch.as_tensor(variables["batch_stats"]["var"])})
    tb.train(train)
    got = tb(torch.as_tensor(x), torch.as_tensor(mask)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tb.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-5)
    np.testing.assert_allclose(tb.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-5)
    if train:  # biased variance over the valid rows only, Flax's momentum
        valid = x[mask]
        np.testing.assert_allclose(tb.running_var.numpy(),
                                   0.9 * variables["batch_stats"]["var"] + 0.1 * valid.var(0),
                                   rtol=1e-5)


def test_edge_conv_and_pool_match(narrow):
    (x, idx, nmask, node_mask), _, _, _ = narrow
    rng = np.random.default_rng(6)
    ec = jedge.EdgeConv(12, train=False)
    variables = ec.init(jax.random.PRNGKey(2), *_j((x, idx, nmask, node_mask)))
    variables = _randomised(jax.tree_util.tree_map(np.asarray, dict(variables)), 6)
    want = np.asarray(ec.apply(variables, *_j((x, idx, nmask, node_mask))))
    te = tedge.EdgeConv(8, 12)
    te.load_state_dict(patch2normal_state_dict_from_variables(variables), strict=True)
    with torch.no_grad():
        got = te.eval()(*_t((x, idx, nmask, node_mask))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    h = rng.normal(size=(x.shape[0], x.shape[1], 7)).astype(np.float32)
    node_mask = node_mask.copy()
    node_mask[0] = False  # an empty patch pools to zeros
    np.testing.assert_allclose(
        tedge.masked_global_pool(torch.as_tensor(h), torch.as_tensor(node_mask)).numpy(),
        np.asarray(jedge.masked_global_pool(jnp.asarray(h), jnp.asarray(node_mask))), atol=1e-6)


def _integer_patches(b=8, p=16, f=4, seed=7):
    """Small-integer features: exact distances, many of them equal."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, (b, p, f)).astype(np.float32)
    node_mask = rng.random((b, p)) < 0.85
    return x, node_mask


def test_dynamic_edge_conv_with_ties_matches(monkeypatch):
    x, node_mask = _integer_patches()
    dc = jedge.DynamicEdgeConv(6, k=5, train=False)
    variables = dc.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(node_mask))
    variables = _randomised(jax.tree_util.tree_map(np.asarray, dict(variables)), 8)
    want = np.asarray(dc.apply(variables, jnp.asarray(x), jnp.asarray(node_mask)))
    td = tedge.DynamicEdgeConv(4, 6, k=5)
    td.load_state_dict(patch2normal_state_dict_from_variables(variables), strict=True)
    with torch.no_grad():
        got = td.eval()(torch.as_tensor(x), torch.as_tensor(node_mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # The ties are real: the higher index first gives another result.
    knn = tedge.masked_pair_knn

    def higher_first(h, m, k):
        idx, mask = knn(torch.flip(h, [1]), torch.flip(m, [1]), k)
        return torch.where(mask, h.shape[1] - 1 - idx, 0), mask

    monkeypatch.setattr(tedge, "masked_pair_knn", higher_first)
    with torch.no_grad():
        flipped = td(torch.as_tensor(x), torch.as_tensor(node_mask)).numpy()
    assert np.abs(flipped - want).max() > 1e-2


def test_model_with_a_dynamic_edge_conv_matches():
    cfg = dict(NARROW, num_edgeconv=5, num_dynamic_edgeconv=1, dynamic_edgeconv_k=4)
    x, node_mask = _integer_patches(b=6, p=32, f=8, seed=9)
    rng = np.random.default_rng(10)
    idx = rng.integers(0, 32, (6, 32, 8)).astype(np.int32)
    nmask = rng.random((6, 32, 8)) < 0.9
    jm, variables, tm = _models(cfg, seed=4)
    want = np.asarray(jm.apply(variables, *_j((x, idx, nmask, node_mask)), train=False))
    with torch.no_grad():
        got = tm(*_t((x, idx, nmask, node_mask))).numpy()
    assert np.abs(got - want).max() <= OUT_TOL


def test_the_port_s_archive_reads_in_the_reference(narrow, tmp_path):
    """``save_variables_npz`` of the port's state; ngpd_tpu's reader takes
    it and gives the same forward."""
    inputs, jm, _, tm = narrow
    save_variables_npz(tmp_path / "w.npz", variables_from_patch2normal_state_dict(tm.state_dict()))
    variables = load_dgcnn_npz(tmp_path / "w.npz")
    want = np.asarray(jm.apply(variables, *_j(inputs), train=False))
    with torch.no_grad():
        got = tm(*_t(inputs)).numpy()
    assert np.abs(got - want).max() <= OUT_TOL


def test_seeded_init_follows_flax_initialisers():
    a = init_patch2normal(seed=0)
    b = init_patch2normal(seed=0)
    c = init_patch2normal(seed=1)
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
        if k.endswith("lin.weight") or k.endswith("_lin.weight") or k == "lastLayer.weight":
            assert not torch.equal(va, vc), k
            fan_in = va.shape[1]
            std = float(va.std())
            assert abs(std * np.sqrt(fan_in) - 1.0) < (0.1 if va.numel() > 1000 else 0.5), k
            # Truncated at two untruncated standard deviations.
            assert float(va.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
        elif k.endswith("running_var") or k.endswith("bn.weight") or k.endswith("_bn.weight"):
            assert torch.equal(va, torch.ones_like(va)), k
        else:
            assert torch.equal(va, torch.zeros_like(va)), k
    assert not a.training
    assert sum(v.numel() for v in a.parameters()) == sum(
        np.asarray(v).size for v in jax.tree_util.tree_leaves(
            init_model(JModelConfig(), JTrainConfig(), jax.random.PRNGKey(0))[1].params))
