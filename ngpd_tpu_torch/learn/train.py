"""The Patch2Normal trainer (torch), as
``ngpd_tpu/learn/train.py``: Adam at ``TrainConfig.learning_rate``, top-k
checkpoints on the monitored sign-invariant loss, early stopping with
patience, and the epoch loop of ``fit``.

``TrainState`` holds the step, the module (its parameters and BatchNorm
statistics), the optimizer and the ``torch.Generator`` that draws the
dropout masks. A train step draws the masks first (``draw_keep_masks``)
and runs the pure forward with them, so a test can feed the reference's
own masks. The optimizer is ``torch.optim.Adam`` in its single-tensor form
(``foreach=False``, ``fused=False``): optax's ``adam`` with the same
moments, bias corrections and eps outside the square root, the operations
in another order (the tests hold the parameters after one and five steps).
With a ``schedule`` the learning rate of an update is
``schedule(count of earlier updates)``, as optax evaluates it.

Both trainers' steps (``train_step`` here, ``dgcnn_train_step`` in
``learn/train_dgcnn.py``) record the spans ``ngpd.train`` around a step,
``ngpd.train.forward`` around the keep masks, the forward and the losses,
and ``ngpd.train.optimizer`` around ``optimise``: zero_grad, the backward
(its own span, ``ngpd.train.backward``, the gradients' mean over a
data-parallel group included) and Adam's step, so the optimizer's self
time is zero_grad and the step. ``STEPS["train"]`` counts the optimizer
steps. Taking a batch from a split staged on the device is the span
``ngpd.train.batch`` (``learn/dataset.py``, ``learn/train_dgcnn.py``).

On a card without a data-parallel group both steps replay CUDA graphs of
the model's train-mode forward and backward (``graphed_forward``), with
the eager step's bits; ``GRAPHS`` counts the captures and the replays.

Metrics accumulate on the device; ``fit`` reads them on the host once an
epoch.

Data parallelism (``fit(mesh=)``, a mesh with a ``"dp"`` axis) keeps the
reference's GSPMD semantics, one program over the global batch: the state
is broadcast from the group's first rank once, every rank takes its rows
of each global batch (which must divide by the group's size), BatchNorm
takes its statistics over the global batch (``models/edgeconv.py``),
each rank draws the keep masks of the whole batch from the shared
generator and applies its rows, and the gradient is the group's mean of
the ranks' mean-loss gradients, which is exact for equal shards of a mean
loss. So a step on d ranks is the single-device step on the same global
batch and masks. Only the group's first rank logs and writes checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import time
import weakref
from pathlib import Path
from typing import Callable, Iterator, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..collectives import all_reduce, broadcast_
from ..config import ModelConfig, TrainConfig
from ..device import exact_float32, resolve_device
from ..kernels import graph
from ..models.patch2normal import Patch2NormalModel, init_patch2normal
from ..utils import prof
from . import losses

STEPS = {"train": 0}  # optimizer steps taken by ``optimise``
GRAPHS = {"capture": 0, "replay": 0}  # CUDA graphs of train steps captured, replayed


def adam(params, learning_rate: float) -> torch.optim.Adam:
    """optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root), one tensor at a time."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            foreach=False, fused=False)


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    schedule: Optional[Callable[[int], float]] = None

    def state_dict(self) -> dict:
        """The step, the optimizer's state and the generator's (the model's
        variables are saved on their own, as a flat ``.npz``)."""
        return {"step": self.step, "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.generator.set_state(sd["generator"])


def new_state(model: nn.Module, learning_rate: float, seed: int, device,
              schedule=None) -> TrainState:
    return TrainState(step=0, model=model, optimizer=adam(model.parameters(), learning_rate),
                      generator=torch.Generator(device).manual_seed(seed), schedule=schedule)


def init_model(model_cfg: ModelConfig = ModelConfig(), train_cfg: TrainConfig = TrainConfig(),
               seed: Optional[int] = None, device=None) -> tuple[Patch2NormalModel, TrainState]:
    """The seeded Patch2Normal (``init_patch2normal``: Flax's initialisers
    drawn from a CPU generator, so the same weights on every device) on
    ``device`` and its train state; ``seed`` defaults to the config's."""
    dev = resolve_device(device)
    exact_float32()
    seed = train_cfg.seed if seed is None else seed
    model = init_patch2normal(model_cfg, seed).to(dev)
    return model, new_state(model, train_cfg.learning_rate, seed, dev)


def dp_group(mesh):
    """The process group of a mesh's ``"dp"`` axis (None without a mesh)."""
    return None if mesh is None else mesh.get_group("dp")


def is_lead(group) -> bool:
    """Whether this rank logs and writes: the group's first, or the only one."""
    return group is None or dist.get_rank(group) == 0


def local_rows(batch: dict, group) -> dict:
    """This rank's rows of a global batch (every value split along axis 0)."""
    if group is None:
        return batch
    d, r = dist.get_world_size(group), dist.get_rank(group)
    b = next(iter(batch.values())).shape[0]
    if b % d:
        raise ValueError(f"a global batch of {b} does not split over {d} data-parallel ranks")
    return {k: v[r * (b // d) : (r + 1) * (b // d)] for k, v in batch.items()}


def draw_local_keep(model: nn.Module, batch: int, generator: torch.Generator, group):
    """The keep masks of this rank's ``batch`` rows: drawn for the whole
    global batch from the generator every rank shares, this rank's rows
    taken."""
    if group is None:
        return model.draw_keep_masks(batch, generator)
    d, r = dist.get_world_size(group), dist.get_rank(group)
    return [k[r * batch : (r + 1) * batch] for k in model.draw_keep_masks(batch * d, generator)]


def broadcast_model(model: nn.Module, group) -> None:
    """The group's first rank's parameters and buffers on every rank."""
    with torch.no_grad():
        broadcast_(list(model.parameters()) + list(model.buffers()), group)


def average_gradients(model: nn.Module, group) -> None:
    """Replace each gradient by the group's mean of it, in one all-reduce."""
    params = [p for p in model.parameters() if p.grad is not None]
    flat = all_reduce(torch.cat([p.grad.reshape(-1) for p in params]), "sum", group)
    flat = flat / dist.get_world_size(group)
    for p, g in zip(params, torch.split(flat, [p.numel() for p in params])):
        p.grad = g.view_as(p)


def optimise(state: TrainState, loss: torch.Tensor, group=None) -> None:
    """One Adam update of ``state.model`` on ``loss``'s gradient; with a
    data-parallel ``group``, on the group's mean of the ranks' gradients."""
    dev = loss.device
    with prof.span("ngpd.train.optimizer", dev):
        if state.schedule is not None:
            for pg in state.optimizer.param_groups:
                pg["lr"] = state.schedule(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        with prof.span("ngpd.train.backward", dev):
            loss.backward()
            if group is not None:
                average_gradients(state.model, group)
        state.optimizer.step()
    state.step += 1
    STEPS["train"] += 1


def _inputs(batch: dict) -> tuple:
    return batch["x"], batch["nbr_idx"], batch["nbr_mask"], batch["node_mask"]


_GRAPHS: "weakref.WeakKeyDictionary[nn.Module, dict]" = weakref.WeakKeyDictionary()


def _addresses(model: nn.Module) -> tuple:
    return tuple(t.data_ptr() for t in (*model.parameters(), *model.buffers()))


def _capture(model: nn.Module, inputs: tuple, keep) -> Callable:
    """The replay of ``model``'s train-mode forward and backward on inputs
    shaped as ``inputs`` (the tensors before ``keep=`` in the model's call)
    with the keep masks ``keep``, and the graph-kernel launches one replay
    makes, added to ``kernels/graph.py::LAUNCHES`` at each call, as the
    eager forward adds them."""
    params = list(model.parameters())
    at = {id(p): i for i, p in enumerate(params)}
    # Every module's slot of a parameter (a module reached by two names,
    # as the DGCNN's ``bn{i}`` and ``conv{i}.1`` are, once).
    slots = [(m, n, at[id(p)]) for m in model.modules() for n, p in m._parameters.items()
             if p is not None]
    # Detached aliases of the parameters (the same storage, new leaves): the
    # capture differentiates them, so no autograd node of an earlier step
    # that a caller still holds on the parameters takes part in it.
    leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
    owner, n_in, n_keep, per_call = weakref.ref(model), len(inputs), len(keep), {}

    def forward(*args):
        before = dict(graph.LAUNCHES)
        for m, n, i in slots:
            m._parameters[n] = args[n_in + n_keep + i]
        try:
            out = owner()(*args[:n_in], keep=list(args[n_in:n_in + n_keep]))
        finally:
            for m, n, i in slots:
                m._parameters[n] = params[i]
        per_call.update({k: graph.LAUNCHES[k] - before[k] for k in before})
        return out

    saved = [b.clone() for b in model.buffers()]
    graphed = torch.cuda.make_graphed_callables(forward, (*inputs, *keep, *leaves),
                                                allow_unused_input=True)
    with torch.no_grad():  # the warm-up's BatchNorm statistics put back
        for b, v in zip(model.buffers(), saved):
            b.copy_(v)
    for k, n in per_call.items():  # the capture recorded its launches, ran none
        graph.LAUNCHES[k] -= n
    GRAPHS["capture"] += 1

    def replay(*inputs, keep, group=None):
        for k, n in per_call.items():
            graph.LAUNCHES[k] += n
        GRAPHS["replay"] += 1
        return graphed(*inputs, *keep, *params)

    return replay


def graphed_forward(state: TrainState, inputs: tuple, keep) -> Callable:
    """A callable with the model's own call, ``f(*inputs, keep=,
    group=None)``, for a train-mode step of ``state.model`` (the DGCNN's
    ``(x,)``, Patch2Normal's ``(x, nbr_idx, nbr_mask, node_mask)``) on
    inputs shaped as ``inputs`` with the keep masks ``keep``.

    On a card, the model's forward and its backward as CUDA graphs
    (``torch.cuda.make_graphed_callables``), captured at the first step of
    each input shape and replayed after: a step then costs the host a few
    launches instead of one for each of the model's hundreds of
    operations, and the card no longer waits on the host. The replays run
    the same kernels on the same operands as the eager step, so they give
    its bits. The capture runs the forward and backward a few times to warm
    up; the BatchNorm statistics those runs move are put back, and the
    parameters are not touched. The keep masks are inputs, drawn outside
    the graphs.

    The graphs read and write the model's parameters and buffers where they
    lie: a loaded state dict or an optimizer step, both in place, keep them
    valid; where any of them moves (a ``.to()`` round trip,
    ``load_state_dict(assign=True)``), the next step captures again. The
    graphs are kept with the model, one an input shape. On the CPU the
    model itself."""
    if not inputs[0].is_cuda:
        return state.model
    graphs = _GRAPHS.setdefault(state.model, {})
    key = (tuple((tuple(t.shape), t.dtype) for t in inputs), inputs[0].device)
    at = _addresses(state.model)
    if graphs.get(key, (None,))[0] != at:
        graphs[key] = (at, _capture(state.model, inputs, keep))
    return graphs[key][1]


def train_step(state: TrainState, batch: dict, keep=None,
               loss_key: str = "custom_val_loss", group=None) -> tuple[TrainState, dict]:
    """One optimization step minimising ``custom_val_loss``; the forward's
    BatchNorm layers update their running statistics. ``keep``: the
    dropout keep masks, drawn from ``state.generator`` when not given.
    ``group``: the data-parallel group; ``batch`` is then this rank's rows.
    On a card without a group the model's forward and backward replay CUDA
    graphs (``graphed_forward``). Returns the state (updated in place) and
    the four metrics (this rank's)."""
    model = state.model.train()
    dev = batch["x"].device
    with prof.span("ngpd.train", dev):
        with prof.span("ngpd.train.forward", dev):
            if keep is None:
                keep = draw_local_keep(model, batch["x"].shape[0], state.generator, group)
            inputs = _inputs(batch)
            forward = model if group is not None else graphed_forward(state, inputs, keep)
            metrics = losses.all_losses(forward(*inputs, keep=keep, group=group), batch["y"])
        optimise(state, metrics[loss_key], group)
    return state, {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(state: TrainState, batch: dict) -> dict:
    out = state.model.eval()(*_inputs(batch))
    return losses.all_losses(out, batch["y"])


@torch.no_grad()
def predict_step(state: TrainState, batch: dict) -> torch.Tensor:
    """L2-normalised predictions (clamp 1e-12)."""
    return state.model.predict(*_inputs(batch))


def acc_metrics(acc: Optional[dict], metrics: dict) -> dict:
    """Running on-device sum of a metrics dict: no host read a step."""
    if acc is None:
        return dict(metrics)
    return {k: acc[k] + v for k, v in metrics.items()}


def host_means(acc: Optional[dict], n: int, group=None) -> dict:
    """The accumulated sums over ``n`` on the host, in one read; with a
    data-parallel ``group``, the mean over its ranks (every rank saw ``n``
    equal shards)."""
    if not acc:
        return {}
    keys = list(acc)
    sums = torch.stack([acc[k] for k in keys])
    if group is not None:
        sums = all_reduce(sums, "sum", group) / dist.get_world_size(group)
    return dict(zip(keys, (v / n for v in sums.tolist())))


@dataclasses.dataclass
class EarlyStopping:
    """Stop after ``patience`` epochs without a new best monitored loss."""

    patience: int = 10
    best: float = float("inf")
    bad_epochs: int = 0

    def update(self, value: float) -> bool:
        """Returns True when training should stop."""
        if value < self.best:
            self.best = value
            self.bad_epochs = 0
            return False
        self.bad_epochs += 1
        return self.bad_epochs > self.patience


class MetricLogger:
    """JSONL metric log: one line per (step, split)."""

    def __init__(self, log_dir: str | Path, name: str = "metrics"):
        self.path = Path(log_dir)
        self.path.mkdir(parents=True, exist_ok=True)
        self.file = self.path / f"{name}.jsonl"

    def log(self, step: int, split: str, metrics: dict):
        rec = {"step": int(step), "split": split, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.file, "a") as f:
            f.write(json.dumps(rec) + "\n")


def fit(
    state: TrainState,
    train_batches: Callable[[], Iterator[dict]],
    val_batches: Callable[[], Iterator[dict]],
    train_cfg: TrainConfig = TrainConfig(),
    log_dir: str | Path = "logs",
    checkpoint_dir: Optional[str | Path] = None,
    mesh=None,
) -> TrainState:
    """Epoch loop with validation, early stopping and checkpointing. The
    monitored loss is ``train_cfg.monitor`` of the validation metrics, the
    training metrics' when there is no full validation batch.

    With ``mesh`` (a ``DeviceMesh`` with a ``"dp"`` axis) every rank runs
    this loop on the same global batches, takes its rows of each, and the
    steps are data-parallel (see the module's docstring)."""
    from .checkpoints import CheckpointManager

    exact_float32()
    group = dp_group(mesh)
    if group is not None:
        broadcast_model(state.model, group)
    lead = is_lead(group)
    logger = MetricLogger(log_dir) if lead else None
    stopper = EarlyStopping(train_cfg.early_stopping_patience)
    ckpt = (CheckpointManager(checkpoint_dir, top_k=train_cfg.checkpoint_top_k)
            if checkpoint_dir and lead else None)

    for epoch in range(train_cfg.num_epochs):
        acc, n_b = None, 0
        last_beat = time.time()
        for batch in train_batches():
            state, metrics = train_step(state, local_rows(batch, group), group=group)
            acc, n_b = acc_metrics(acc, metrics), n_b + 1
            if lead and time.time() - last_beat > 120:
                print(f"epoch {epoch}: step {n_b}...", flush=True)
                last_beat = time.time()
        train_metrics = host_means(acc, n_b, group)

        acc, n_b = None, 0
        for batch in val_batches():
            acc, n_b = acc_metrics(acc, eval_step(state, local_rows(batch, group))), n_b + 1
        val_metrics = host_means(acc, n_b, group)
        if not val_metrics:
            # Tiny datasets can yield zero full validation batches.
            val_metrics = dict(train_metrics)
        monitored = val_metrics.get(train_cfg.monitor.replace("val_", ""),
                                    val_metrics["custom_val_loss"])
        if lead:
            logger.log(epoch, "train", train_metrics)
            logger.log(epoch, "val", val_metrics)
            print(f"epoch {epoch}: train {train_metrics.get('custom_val_loss'):.5f} "
                  f"val {monitored:.5f}")
        if ckpt is not None:
            ckpt.save(epoch, state, monitored)
        if epoch + 1 >= train_cfg.min_epochs and stopper.update(monitored):
            if lead:
                print(f"early stop at epoch {epoch} (best {stopper.best:.5f})")
            break
    return state
