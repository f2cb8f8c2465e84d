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

Metrics accumulate on the device; ``fit`` reads them on the host once an
epoch.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import torch
from torch import nn

from ..config import ModelConfig, TrainConfig
from ..device import exact_float32, resolve_device
from ..models.patch2normal import Patch2NormalModel, init_patch2normal
from . import losses


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


def optimise(state: TrainState, loss: torch.Tensor) -> None:
    """One Adam update of ``state.model`` on ``loss``'s gradient."""
    if state.schedule is not None:
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1


def _inputs(batch: dict) -> tuple:
    return batch["x"], batch["nbr_idx"], batch["nbr_mask"], batch["node_mask"]


def train_step(state: TrainState, batch: dict, keep=None,
               loss_key: str = "custom_val_loss") -> tuple[TrainState, dict]:
    """One optimization step minimising ``custom_val_loss``; the forward's
    BatchNorm layers update their running statistics. ``keep``: the
    dropout keep masks, drawn from ``state.generator`` when not given.
    Returns the state (updated in place) and the four metrics."""
    model = state.model.train()
    if keep is None:
        keep = model.draw_keep_masks(batch["x"].shape[0], state.generator)
    metrics = losses.all_losses(model(*_inputs(batch), keep=keep), batch["y"])
    optimise(state, metrics[loss_key])
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


def host_means(acc: Optional[dict], n: int) -> dict:
    """The accumulated sums over ``n`` on the host, in one read."""
    if not acc:
        return {}
    keys = list(acc)
    return dict(zip(keys, (v / n for v in torch.stack([acc[k] for k in keys]).tolist())))


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
) -> TrainState:
    """Epoch loop with validation, early stopping and checkpointing. The
    monitored loss is ``train_cfg.monitor`` of the validation metrics, the
    training metrics' when there is no full validation batch."""
    from .checkpoints import CheckpointManager

    exact_float32()
    logger = MetricLogger(log_dir)
    stopper = EarlyStopping(train_cfg.early_stopping_patience)
    ckpt = (CheckpointManager(checkpoint_dir, top_k=train_cfg.checkpoint_top_k)
            if checkpoint_dir else None)

    for epoch in range(train_cfg.num_epochs):
        acc, n_b = None, 0
        last_beat = time.time()
        for batch in train_batches():
            state, metrics = train_step(state, batch)
            acc, n_b = acc_metrics(acc, metrics), n_b + 1
            if time.time() - last_beat > 120:
                print(f"epoch {epoch}: step {n_b}...", flush=True)
                last_beat = time.time()
        train_metrics = host_means(acc, n_b)
        logger.log(epoch, "train", train_metrics)

        acc, n_b = None, 0
        for batch in val_batches():
            acc, n_b = acc_metrics(acc, eval_step(state, batch)), n_b + 1
        val_metrics = host_means(acc, n_b)
        if not val_metrics:
            # Tiny datasets can yield zero full validation batches.
            val_metrics = dict(train_metrics)
        logger.log(epoch, "val", val_metrics)
        monitored = val_metrics.get(train_cfg.monitor.replace("val_", ""),
                                    val_metrics["custom_val_loss"])
        print(f"epoch {epoch}: train {train_metrics.get('custom_val_loss'):.5f} "
              f"val {monitored:.5f}")
        if ckpt is not None:
            ckpt.save(epoch, state, monitored)
        if epoch + 1 >= train_cfg.min_epochs and stopper.update(monitored):
            print(f"early stop at epoch {epoch} (best {stopper.best:.5f})")
            break
    return state
