"""The Patch2Normal trainer of the port (``learn/{losses,train,checkpoints,
export}.py``, the dropout split of ``models/patch2normal.py``) against
ngpd_tpu on the CPU, on identical weights, batches and dropout masks.

The workload: a narrow ``ModelConfig`` (hidden 16-64) on 4 patches of 64
nodes and 12 neighbours from the reference's ``extract_patches`` of a noisy
sphere; the reference's ``init_model`` weights with the BatchNorm
statistics, scales and biases randomised (a carry that swapped two of them
would pass on a fresh initialisation), carried across with
``patch2normal_state_dict_from_variables``. The reference's step is its own
``make_train_step``, run op by op; its gradients come from
``jax.value_and_grad`` of the same loss. Not jitted: under the tests'
conftest (``JAX_DISABLE_MOST_OPTIMIZATIONS=1``) the jitted step moves ~13%
of ``layer6_lin``'s entries against the sign of the gradient that the same
step gives op by op (read on this workload), which no rounding explains.

Tolerances (``-s`` prints the readings): the losses to 1e-6 relative; the
loss of a step to 1e-5 relative, its other metrics to 1e-5 absolute too
(``cos_loss`` is a mean of signed cosines); each parameter's gradient to
1e-4 of max(its norm, 1e-3 x the largest parameter's gradient norm)
(float32 products and sums in another order, two BLAS: readings up to
~4e-5). The floor is for the biases that feed a BatchNorm, directly or
through a linear map (``layer7_lin``, ``layer8_lin``, ``layer7_bn`` with
dropout off): their gradient is zero in exact arithmetic and rounding
noise (~1e-7) in both packages. The new ``batch_stats`` to 1e-5 of
max(|entry|, 1), as tests/test_torch_patch2normal.py holds a train-mode
forward. After Adam: an update is lr * m / (sqrt(v) + eps), about
lr * sign(g) on the first step, so where a gradient entry is within its
rounding of 0 the two updates may take either sign. Parameters are held to
1e-6 absolute where the gradient entry exceeds 1e-3 of its parameter's
largest (noise-gradient parameters left out), and to 2 lr everywhere. After
five steps the moments mix five gradients, and an entry whose gradient
changed sign has m near 0 and m / sqrt(v) sensitive to its rounding: 5e-5
(1% of five lr, readings 1.2e-5) and 10 lr. The share of entries outside
the tight bound is read (under 0.005%) and held under 1%.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from ngpd_tpu.config import ModelConfig as JModelConfig
from ngpd_tpu.config import PatchConfig as JPatchConfig
from ngpd_tpu.config import TrainConfig as JTrainConfig
from ngpd_tpu.core import patches as jpatches
from ngpd_tpu.learn import losses as jlosses
from ngpd_tpu.learn import train as jtrain
from ngpd_tpu.learn.checkpoints import CheckpointManager as JCheckpointManager
from ngpd_tpu.learn.weights import flatten_variables, load_dgcnn_npz, unflatten_variables
from ngpd_tpu_torch.config import ModelConfig, TrainConfig
from ngpd_tpu_torch.learn import losses as tlosses
from ngpd_tpu_torch.learn import train as ttrain
from ngpd_tpu_torch.learn.checkpoints import CheckpointManager
from ngpd_tpu_torch.learn.export import export_predict, load_exported, save_exported
from ngpd_tpu_torch.learn.weights import (patch2normal_state_dict_from_variables,
                                          variables_from_patch2normal_state_dict)
from ngpd_tpu_torch.models.patch2normal import Patch2NormalModel

from fixtures import sphere_cloud

torch.set_num_threads(2)

NARROW = dict(hidden=(16, 16, 32, 32, 32, 32, 64, 32, 16))
BATCH = 4
LR = 1e-3
GRAD_TOL = 1e-4  # of each parameter's gradient norm
STATS_TOL = 1e-5  # of max(|entry|, 1)
CLEAR_GRAD = 1e-3  # gradient entries above this share of their largest
NULL_GRAD = 1e-3  # gradient norms below this share of the largest are noise
PARAM_TOL_1, PARAM_TOL_5 = 1e-6, 5e-5
FLIP_SHARE = 0.01


def _batch(seed=2):
    pts, nrm = sphere_cloud(200, seed=seed)
    pts = pts + np.random.default_rng(5).normal(scale=0.01, size=pts.shape).astype(np.float32)
    b = jpatches.extract_patches(jnp.asarray(pts), jnp.asarray(nrm), cfg=JPatchConfig())
    take = np.array([3, 50, 97, 150])
    return {k: np.asarray(getattr(b, k))[take] for k in ("x", "nbr_idx", "nbr_mask",
                                                         "node_mask", "y")}


def _randomised(variables, seed=0):
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


def _flat_grads(model):
    """The port's gradients as flat Flax paths (kernels transposed)."""
    sd = {k: p.grad for k, p in model.named_parameters()}
    return flatten_variables(variables_from_patch2normal_state_dict(sd))


def _flat_params(model):
    return flatten_variables({"params": variables_from_patch2normal_state_dict(
        {k: p for k, p in model.named_parameters()})["params"]})


def _pair(dropout_rate, seed=0):
    cfg = dict(NARROW, dropout_rate=dropout_rate)
    jm, st, tx = jtrain.init_model(JModelConfig(**cfg), JTrainConfig(), jax.random.PRNGKey(seed))
    variables = _randomised({"params": st.params, "batch_stats": st.batch_stats}, seed)
    jstate = jtrain.TrainState.create(variables, tx, jax.random.PRNGKey(seed + 7))
    tm = Patch2NormalModel(ModelConfig(**cfg))
    tm.load_state_dict(patch2normal_state_dict_from_variables(variables), strict=True)
    return jm, jstate, tx, ttrain.new_state(tm, LR, seed, "cpu")


def _ref_grads(jm, jstate, batch, drng):
    def loss_fn(params):
        out, upd = jm.apply({"params": params, "batch_stats": jstate.batch_stats},
                            batch["x"], batch["nbr_idx"], batch["nbr_mask"],
                            batch["node_mask"], train=True, mutable=["batch_stats"],
                            rngs={"dropout": drng})
        return jlosses.custom_val_loss(out, batch["y"]), upd

    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(jstate.params)
    return float(loss), flatten_variables({"params": grads})


def _ref_keep_masks(jm, jstate, batch, drng):
    """Flax's dropout keep masks of this step: a kept entry is nonzero in
    the output of ``nn.Dropout.__call__``."""
    masks = []

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            masks.append(np.asarray(out) != 0)
        return out

    with fnn.intercept_methods(capture):
        jm.apply({"params": jstate.params, "batch_stats": jstate.batch_stats},
                 batch["x"], batch["nbr_idx"], batch["nbr_mask"], batch["node_mask"],
                 train=True, mutable=["batch_stats"], rngs={"dropout": drng})
    return masks


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _live(grads):
    """Parameters whose gradient is not zero in exact arithmetic: a bias
    feeding a BatchNorm, directly or through a linear map, has a gradient
    of rounding noise (~1e-7 here) in both packages."""
    norms = {k: np.linalg.norm(np.asarray(g)) for k, g in grads.items()}
    top = max(norms.values())
    return {k for k, n in norms.items() if n > NULL_GRAD * top}


def _grad_errors(got, want):
    """Each gradient's error over max(its norm, NULL_GRAD x the largest)."""
    norms = {k: np.linalg.norm(np.asarray(g)) for k, g in want.items()}
    floor = NULL_GRAD * max(norms.values())
    return {k: float(np.linalg.norm(got[k] - np.asarray(want[k])) / max(norms[k], floor))
            for k in want}


def _param_check(got, want, grads, tight, loose, lr):
    worst_clear, worst, off = 0.0, 0.0, 0
    total = 0
    live = _live(grads)
    for k, w in want.items():
        w = np.asarray(w)
        d = np.abs(got[k] - w)
        worst = max(worst, float(d.max()))
        if k not in live:
            continue
        g = np.abs(np.asarray(grads[k]))
        clear = g > CLEAR_GRAD * max(g.max(), 1e-30)
        worst_clear = max(worst_clear, float(d[clear].max()) if clear.any() else 0.0)
        off += int((d > tight).sum())
        total += d.size
    print("params: clear", worst_clear, "all", worst, "share over", off / total)
    assert worst_clear <= tight
    assert worst <= loose * lr
    assert off / total <= FLIP_SHARE


def _run_steps(dropout_rate, n_steps):
    batch = _batch()
    jm, jstate, tx, tstate = _pair(dropout_rate)
    jstep = jtrain.make_train_step(jm, tx)
    first = None
    for i in range(n_steps):
        drng = jax.random.split(jstate.rng)[1]
        loss, grads = _ref_grads(jm, jstate, batch, drng)
        keep = ([torch.as_tensor(m) for m in _ref_keep_masks(jm, jstate, batch, drng)]
                if dropout_rate else None)
        jstate, jmetrics = jstep(jstate, batch)
        tstate, tmetrics = ttrain.train_step(tstate, _tbatch(batch), keep=keep)
        if i == 0:
            first = dict(loss=loss, grads=grads, jmetrics=jmetrics, tmetrics=tmetrics,
                         tgrads=_flat_grads(tstate.model), keep=keep,
                         jstats=flatten_variables({"batch_stats": jstate.batch_stats}),
                         tstats=flatten_variables({"batch_stats": variables_from_patch2normal_state_dict(
                             tstate.model.state_dict())["batch_stats"]}),
                         jparams=flatten_variables({"params": jstate.params}),
                         tparams=_flat_params(tstate.model))
    return first, dict(grads=grads, jparams=flatten_variables({"params": jstate.params}),
                       tparams=_flat_params(tstate.model), tstate=tstate, jstate=jstate)


@pytest.fixture(scope="module")
def no_dropout():
    return _run_steps(0.0, 5)


@pytest.fixture(scope="module")
def with_dropout():
    return _run_steps(0.5, 1)


def test_losses_match():
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(40, 3)).astype(np.float32)
    target = rng.normal(size=(40, 3)).astype(np.float32)
    pred[3] = 0.0  # the cosine's clamp
    want = jlosses.all_losses(jnp.asarray(pred), jnp.asarray(target))
    got = tlosses.all_losses(torch.as_tensor(pred), torch.as_tensor(target))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(
        tlosses.cosine_similarity(torch.as_tensor(pred), torch.as_tensor(target)).numpy(),
        np.asarray(jlosses.cosine_similarity(jnp.asarray(pred), jnp.asarray(target))),
        rtol=1e-6, atol=1e-7)


def _check_step(first):
    np.testing.assert_allclose(float(first["tmetrics"]["custom_val_loss"]), first["loss"],
                               rtol=1e-5)
    for k, v in first["jmetrics"].items():  # cos_loss: a mean of signed cosines
        np.testing.assert_allclose(float(first["tmetrics"][k]), float(v), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    errs = _grad_errors(first["tgrads"], first["grads"])
    print("gradient errors (of norm): max", max(errs.values()))
    assert max(errs.values()) <= GRAD_TOL, errs
    assert all(np.linalg.norm(np.asarray(g)) > 0 for g in first["grads"].values())


def test_one_step_without_dropout(no_dropout):
    first, _ = no_dropout
    _check_step(first)
    for k, v in first["jstats"].items():
        v = np.asarray(v)
        assert (np.abs(first["tstats"][k] - v) / np.maximum(np.abs(v), 1.0)).max() <= STATS_TOL
    _param_check(first["tparams"], first["jparams"], first["grads"], PARAM_TOL_1, 2, LR)


def test_five_steps_without_dropout(no_dropout):
    _, last = no_dropout
    assert last["tstate"].step == 5 and int(last["jstate"].step) == 5
    _param_check(last["tparams"], last["jparams"], last["grads"], PARAM_TOL_5, 10, LR)


def test_one_step_with_the_reference_s_dropout_masks(with_dropout):
    first, _ = with_dropout
    keep = first["keep"]
    assert [tuple(m.shape) for m in keep] == [(BATCH, 32), (BATCH, 16)]
    share = float(np.mean(np.concatenate([m.numpy().ravel() for m in keep])))
    assert 0.2 < share < 0.8  # the masks drop, at about half
    _check_step(first)
    _param_check(first["tparams"], first["jparams"], first["grads"], PARAM_TOL_1, 2, LR)


def test_train_mode_needs_keep_masks_when_dropout_is_on():
    _, _, _, tstate = _pair(0.5)
    batch = _tbatch(_batch())
    with pytest.raises(ValueError, match="keep masks"):
        tstate.model.train()(batch["x"], batch["nbr_idx"], batch["nbr_mask"],
                             batch["node_mask"])
    # Drawn from the state's generator: the same seed draws the same masks.
    a = tstate.model.draw_keep_masks(BATCH, torch.Generator().manual_seed(3))
    b = tstate.model.draw_keep_masks(BATCH, torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_eval_and_predict_steps_match():
    """On the carried weights (after training steps the noise-gradient
    biases differ by up to lr, and eval mode reads them)."""
    batch = _batch(seed=4)
    jm, jstate, _, tstate = _pair(0.0)
    want = jtrain.make_eval_step(jm)(jstate, batch)
    got = ttrain.eval_step(tstate, _tbatch(batch))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-5)
    pj = np.asarray(jtrain.make_predict_step(jm)(jstate, batch))
    pt = ttrain.predict_step(tstate, _tbatch(batch)).numpy()
    np.testing.assert_allclose(pt, pj, atol=2e-4)


def test_early_stopping_and_metric_logger_match(tmp_path):
    seq = [0.5, 0.4, 0.45, 0.41, 0.4, 0.39, 0.5, 0.6, 0.7]
    ja, ta = jtrain.EarlyStopping(patience=2), ttrain.EarlyStopping(patience=2)
    assert [ja.update(v) for v in seq] == [ta.update(v) for v in seq]
    assert (ja.best, ja.bad_epochs) == (ta.best, ta.bad_epochs)
    jl = jtrain.MetricLogger(tmp_path / "j")
    tl = ttrain.MetricLogger(tmp_path / "t")
    for step, split in ((0, "train"), (0, "val"), (1, "train")):
        jl.log(step, split, {"a": np.float32(0.25), "b": 3})
        tl.log(step, split, {"a": torch.tensor(0.25), "b": 3})

    def lines(path):
        return [{k: v for k, v in json.loads(ln).items() if k != "time"}
                for ln in path.read_text().splitlines()]

    assert lines(tmp_path / "t" / "metrics.jsonl") == lines(tmp_path / "j" / "metrics.jsonl")


def test_checkpoints_keep_the_reference_s_top_k(no_dropout, tmp_path):
    """The same (step, score) sequence through both managers: the same
    scores.json and the same step directories; the port's restore gives
    back the model, optimizer, generator and step it saved."""
    first, last = no_dropout
    tstate, jstate = last["tstate"], last["jstate"]
    jm_ = JCheckpointManager(tmp_path / "j", top_k=2)
    tm_ = CheckpointManager(tmp_path / "t", top_k=2)
    for step, score in ((0, 0.5), (1, 0.3), (2, 0.4), (1, 0.6), (3, 0.2)):
        jm_.save(step, jstate, score)
        jm_._ckpt.wait_until_finished()  # orbax writes in the background
        tm_.save(step, tstate, score)
    assert (json.loads((tmp_path / "t" / "scores.json").read_text())
            == json.loads((tmp_path / "j" / "scores.json").read_text()))
    assert (sorted(p.name for p in (tmp_path / "t").iterdir())
            == sorted(p.name for p in (tmp_path / "j").iterdir()))
    assert tm_.best_step() == jm_.best_step() == 3

    saved = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    gen_state = tstate.generator.get_state()
    fresh = _pair(0.0, seed=1)[3]
    tm_.restore(fresh)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert fresh.step == tstate.step
    assert torch.equal(fresh.generator.get_state(), gen_state)
    got = fresh.optimizer.state_dict()["state"]
    want = tstate.optimizer.state_dict()["state"]
    assert all(torch.equal(got[i]["exp_avg_sq"], want[i]["exp_avg_sq"]) for i in want)


def test_port_checkpoint_reads_in_the_reference(no_dropout, tmp_path):
    """A port checkpoint's variables.npz through ngpd_tpu's reader: the
    same eval forward."""
    _, last = no_dropout
    ckpt = CheckpointManager(tmp_path, top_k=1)
    ckpt.save(4, last["tstate"], 0.1)
    variables = load_dgcnn_npz(ckpt.variables_path())
    batch = _batch(seed=4)
    jm = jtrain.Patch2NormalModel(JModelConfig(**NARROW))
    want = np.asarray(jm.apply(variables, batch["x"], batch["nbr_idx"], batch["nbr_mask"],
                               batch["node_mask"], train=False))
    with torch.no_grad():
        b = _tbatch(batch)
        got = last["tstate"].model.eval()(b["x"], b["nbr_idx"], b["nbr_mask"],
                                          b["node_mask"]).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_export_round_trip(no_dropout, tmp_path):
    _, last = no_dropout
    b = _tbatch(_batch(seed=4))
    args = (b["x"], b["nbr_idx"], b["nbr_mask"], b["node_mask"])
    last["tstate"].model.train()
    blob = export_predict(last["tstate"], b)
    save_exported(tmp_path / "p2n.pt2", blob)
    del b
    fn = load_exported(tmp_path / "p2n.pt2")
    want = last["tstate"].model.predict(*args)
    torch.testing.assert_close(fn(*args), want, rtol=0, atol=1e-6)
    assert last["tstate"].model.training  # export left the mode as it was
    torch.testing.assert_close(load_exported(blob)(*args), want, rtol=0, atol=1e-6)


def test_fit_runs_the_reference_s_epoch_loop(tmp_path, capsys):
    """``fit`` with no validation batch monitors the training loss, logs a
    train and a val line an epoch, checkpoints every epoch, and stops
    early after min_epochs once the loss stops falling."""
    batch = _tbatch(_batch())
    _, _, _, tstate = _pair(0.0)
    cfg = TrainConfig(num_epochs=6, min_epochs=2, early_stopping_patience=0,
                      checkpoint_top_k=2, learning_rate=LR)
    calls = {"n": 0}

    def train_batches():
        calls["n"] += 1
        yield batch

    ttrain.fit(tstate, train_batches, lambda: iter(()), cfg, log_dir=tmp_path / "logs",
               checkpoint_dir=tmp_path / "ckpts")
    said = capsys.readouterr().out.splitlines()
    logs = [json.loads(ln) for ln in (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    epochs = calls["n"]
    assert [ln["split"] for ln in logs] == ["train", "val"] * epochs
    assert all(ln["custom_val_loss"] == logs[2 * i]["custom_val_loss"]
               for i, ln in enumerate(logs[1::2]))
    assert sum(s.startswith("epoch ") for s in said) == epochs
    scores = json.loads((tmp_path / "ckpts" / "scores.json").read_text())
    assert len(scores) == min(2, epochs)
    assert tstate.step == epochs
