"""The mesh track's trainer (torch), as ``ngpd_tpu/learn/train_dgcnn.py``:
the DGCNN patch -> normal regression with Adam at 1e-4 and the loss
alpha * cosine-embedding + beta * MSE (alpha 0, beta 1 by default).

``init_dgcnn`` builds a seeded DGCNN (Flax's initialisers in distribution)
and its ``TrainState``; with ``decay_steps`` the learning rate follows
optax's ``cosine_decay_schedule(lr, decay_steps, alpha=0.05)``, evaluated
at the count of earlier updates. ``ShardStore`` reads the collector's
shards, or takes patches in memory (``from_patches``, such as the
collector's ``MeshPatchBatch``), and draws its permutations from one
``numpy.random.default_rng``, in the reference's order, so the validation
split, the batches and ``sel_blocks`` are the reference's; its
``state_dict`` holds where that generator stands, so a resumed run draws
the same batches. ``fit_dgcnn`` returns the state of the best validation
MSE. ``scan_steps > 0`` walks the same batches in blocks of that many steps
(the reference's ``lax.scan`` supersteps; here a plain loop over each
block's rows, from the split staged on the device).
``fit_dgcnn(mesh=)`` is data-parallel as ``learn/train.py::fit`` is. On a
card without a data-parallel group, a step's forward and backward replay
CUDA graphs of the model (``learn/train.py::graphed_forward``, which
Patch2Normal's ``train_step`` shares), with the eager step's bits.
"""

from __future__ import annotations

import copy
import math
import os
import time
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..device import exact_float32, resolve_device
from ..models.dgcnn import DGCNN
from ..models.patch2normal import flax_init_
from ..utils import prof
from .train import (EarlyStopping, MetricLogger, TrainState, acc_metrics, broadcast_model,
                    dp_group, draw_local_keep, graphed_forward, host_means, is_lead,
                    local_rows, new_state, optimise)

COSINE_ALPHA = 0.05


def cosine_decay(learning_rate: float, decay_steps: int, alpha: float = COSINE_ALPHA):
    """optax.cosine_decay_schedule: lr * ((1 - alpha) * 0.5 * (1 + cos(pi *
    min(t, T) / T)) + alpha)."""

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        return learning_rate * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps))
                                + alpha)

    return schedule


def init_dgcnn(
    seed: int = 0,
    emb_dims: int = 1024,
    learning_rate: float = 1e-4,
    decay_steps: Optional[int] = None,
    device=None,
) -> tuple[DGCNN, TrainState]:
    """A seeded DGCNN(k 8, emb_dims, dropout 0.5) on ``device`` (the same
    weights on every device: drawn from a CPU generator) and its state:
    Adam at ``learning_rate``, cosine-decayed over ``decay_steps`` when
    given."""
    dev = resolve_device(device)
    exact_float32()
    model = flax_init_(DGCNN(emb_dims=emb_dims), seed).to(dev)
    schedule = cosine_decay(learning_rate, decay_steps) if decay_steps else None
    return model, new_state(model, learning_rate, seed, dev, schedule)


def dgcnn_losses(pred: torch.Tensor, target: torch.Tensor) -> dict:
    """The cosine-embedding loss with target 1 (mean of 1 - cos), the MSE
    and the mean angular error in degrees."""
    pn = pred / torch.clamp(torch.linalg.norm(pred, dim=-1, keepdim=True), min=1e-12)
    tn = target / torch.clamp(torch.linalg.norm(target, dim=-1, keepdim=True), min=1e-12)
    dot = torch.sum(pn * tn, dim=-1)
    return {"cos_loss": torch.mean(1.0 - dot),
            "mse_loss": torch.mean((pred - target) ** 2),
            "angular_deg": torch.rad2deg(torch.mean(torch.arccos(torch.clamp(dot, -1, 1))))}


def dgcnn_train_step(state: TrainState, batch: dict, keep=None, alpha: float = 0.0,
                     beta: float = 1.0, group=None) -> tuple[TrainState, dict]:
    """One step on alpha * cos + beta * mse; ``keep``, ``group`` and the
    spans as in ``learn/train.py::train_step``. On a card without a
    data-parallel group the model's forward and backward replay CUDA graphs
    (``graphed_forward``). Returns the state and the metrics with the
    loss."""
    model = state.model.train()
    dev = batch["x"].device
    with prof.span("ngpd.train", dev):
        with prof.span("ngpd.train.forward", dev):
            if keep is None:
                keep = draw_local_keep(model, batch["x"].shape[0], state.generator, group)
            forward = model if group is not None else graphed_forward(state, (batch["x"],), keep)
            metrics = dgcnn_losses(forward(batch["x"], keep=keep, group=group), batch["y"])
            loss = alpha * metrics["cos_loss"] + beta * metrics["mse_loss"]
        optimise(state, loss, group)
    return state, {**{k: v.detach() for k, v in metrics.items()}, "loss": loss.detach()}


@torch.no_grad()
def dgcnn_eval_step(state: TrainState, batch: dict) -> dict:
    return dgcnn_losses(state.model.eval()(batch["x"]), batch["y"])


class ShardStore:
    """The collector's shards in memory, shuffled batches of them on the
    device."""

    DEVICE_STAGE_BYTES = int(os.environ.get("NGPD_STAGE_BYTES", 2 << 30))

    def __init__(self, shard_paths: Sequence[str], val_fraction: float = 0.1,
                 seed: int = 0, max_patches: Optional[int] = None, device=None):
        xs, ys = [], []
        for p in shard_paths:
            with np.load(p) as d:
                xs.append(np.asarray(d["x"], np.float32))
                ys.append(np.asarray(d["y"], np.float32))
        self._split(xs, ys, val_fraction, seed, max_patches, device)

    @classmethod
    def from_patches(cls, batches: Sequence, val_fraction: float = 0.1, seed: int = 0,
                     max_patches: Optional[int] = None, device=None) -> "ShardStore":
        """The store of in-memory patches, each of ``batches`` a shard's
        ``inputs`` (B, 20, P) and ``y`` (B, 3) (a ``MeshPatchBatch``, on any
        device): the split, permutations and batches of the store read from
        the same arrays saved as shards."""
        store = cls.__new__(cls)
        store._split([np.asarray(b.inputs.detach().cpu(), np.float32) for b in batches],
                     [np.asarray(b.y.detach().cpu(), np.float32) for b in batches],
                     val_fraction, seed, max_patches, device)
        return store

    def _split(self, xs, ys, val_fraction, seed, max_patches, device) -> None:
        self.device = resolve_device(device)
        x = np.concatenate(xs, axis=0)
        y = np.concatenate(ys, axis=0)
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(x))
        x, y = x[perm], y[perm]
        if max_patches is not None and len(x) > max_patches:
            x, y = x[:max_patches], y[:max_patches]
        n_val = int(len(x) * val_fraction)
        self.val = {"x": x[:n_val], "y": y[:n_val]}
        self.train = {"x": x[n_val:], "y": y[n_val:]}
        self._rng = rng
        self._dev: dict = {}

    def state_dict(self) -> dict:
        """Where the generator of the batch order stands."""
        return {"rng": self._rng.bit_generator.state}

    def load_state_dict(self, sd: dict) -> None:
        self._rng.bit_generator.state = sd["rng"]

    def _staged(self, split: str):
        if split not in self._dev:
            data = getattr(self, split)
            total = data["x"].nbytes + data["y"].nbytes
            self._dev[split] = ({k: torch.as_tensor(v).to(self.device) for k, v in data.items()}
                                if total <= self.DEVICE_STAGE_BYTES else False)
        return self._dev[split]

    def _take(self, split: str, sel) -> dict:
        """The rows ``sel`` of a split: an index tensor on the device where
        the split is staged there, else a numpy index into the host split
        (the span ``ngpd.train.batch``)."""
        dev = self._staged(split)
        with prof.span("ngpd.train.batch", self.device):
            if dev:
                return {k: v[sel] for k, v in dev.items()}
            return {k: torch.as_tensor(v[sel]).to(self.device)
                    for k, v in getattr(self, split).items()}

    def batches(self, split: str, batch_size: int, shuffle: bool = True) -> Iterator[dict]:
        """The split's full batches in this epoch's order. Where the split is
        staged on the device, the order goes there in one copy at the first
        batch; a batch is then a slice of it, with no host copy that would
        wait for the device a step."""
        n = len(getattr(self, split)["x"])
        order = self._rng.permutation(n) if shuffle else np.arange(n)
        if self._staged(split):
            order = torch.as_tensor(order, device=self.device)
        for s in range(0, n - batch_size + 1, batch_size):
            yield self._take(split, order[s : s + batch_size])

    def staged(self, split: str) -> dict:
        """The split on the device, for the block path."""
        dev = self._staged(split)
        if dev is False:
            raise ValueError(f"{split} split exceeds NGPD_STAGE_BYTES "
                             f"({self.DEVICE_STAGE_BYTES}); the block path needs the split "
                             "staged on the device: raise the budget or use the per-step path")
        return dev

    def sel_blocks(self, split: str, batch_size: int, scan_steps: int,
                   shuffle: bool = True) -> Iterator[np.ndarray]:
        """(S, B) index blocks covering the split's full batches, the last
        block shorter when the count does not divide."""
        n = len(getattr(self, split)["x"])
        order = self._rng.permutation(n) if shuffle else np.arange(n)
        n_full = n // batch_size
        flat = order[: n_full * batch_size].reshape(n_full, batch_size)
        for s in range(0, n_full, scan_steps):
            yield flat[s : s + scan_steps]


def _split_batches(store: ShardStore, split: str, batch_size: int, scan_steps: int,
                   shuffle: bool) -> Iterator[dict]:
    """The batches of one epoch's split: per step, or block by block from
    the staged split (the same batches in the same order either way)."""
    if not scan_steps:
        yield from store.batches(split, batch_size, shuffle=shuffle)
        return
    staged = store.staged(split)
    for blk in store.sel_blocks(split, batch_size, scan_steps, shuffle=shuffle):
        idx = torch.as_tensor(blk, device=store.device)
        for row in idx:
            yield {k: v[row] for k, v in staged.items()}


def _snapshot(state: TrainState) -> dict:
    return {"model": copy.deepcopy(state.model.state_dict()),
            "train": copy.deepcopy(state.state_dict())}


def fit_dgcnn(
    state: TrainState,
    store: ShardStore,
    batch_size: int = 256,
    num_epochs: int = 24,
    alpha: float = 0.0,
    beta: float = 1.0,
    patience: int = 10,
    log_dir: str | Path = "logs/dgcnn",
    checkpoint_dir: Optional[str | Path] = None,
    scan_steps: int = 0,
    mesh=None,
) -> TrainState:
    """Epoch loop: per-epoch validation, top-k checkpoints, early stopping;
    returns the state (model, optimizer, generator, step) of the epoch with
    the lowest validation MSE. With ``mesh`` (a ``DeviceMesh`` with a
    ``"dp"`` axis) every rank walks the same store's batches and takes its
    rows of each (``learn/train.py``); the block path is one device's."""
    from .checkpoints import CheckpointManager

    if scan_steps and mesh is not None:
        raise ValueError(
            "scan_steps amortizes per-step dispatch on ONE device; "
            "with a mesh, use the dp-sharded per-step path"
        )
    exact_float32()
    group = dp_group(mesh)
    if group is not None:
        broadcast_model(state.model, group)
    lead = is_lead(group)
    logger = MetricLogger(log_dir) if lead else None
    stopper = EarlyStopping(patience)
    ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir and lead else None
    best = _snapshot(state)
    for epoch in range(num_epochs):
        t0 = time.time()
        acc, n_b, last_beat = None, 0, time.time()
        for batch in _split_batches(store, "train", batch_size, scan_steps, True):
            state, metrics = dgcnn_train_step(state, local_rows(batch, group), alpha=alpha,
                                              beta=beta, group=group)
            acc, n_b = acc_metrics(acc, metrics), n_b + 1
            if lead and time.time() - last_beat > 120:
                print(f"epoch {epoch}: step {n_b}...", flush=True)
                last_beat = time.time()
        if acc is None:
            raise ValueError(f"no full train batches: split has {len(store.train['x'])} "
                             f"patches < batch_size {batch_size} — shrink the batch or add data")
        train_metrics = host_means(acc, n_b, group)

        acc, n_b = None, 0
        for batch in _split_batches(store, "val", batch_size, scan_steps, False):
            acc = acc_metrics(acc, dgcnn_eval_step(state, local_rows(batch, group)))
            n_b += 1
        val_metrics = host_means(acc, n_b, group) or dict(train_metrics)
        monitored = val_metrics["mse_loss"]
        if lead:
            logger.log(epoch, "train", train_metrics)
            logger.log(epoch, "val", val_metrics)
            print(f"epoch {epoch}: train mse {train_metrics['mse_loss']:.5f} "
                  f"val mse {monitored:.5f} val ang {val_metrics['angular_deg']:.2f}deg "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if ckpt is not None:
            ckpt.save(epoch, state, monitored)
        if monitored <= stopper.best:
            best = _snapshot(state)
        if stopper.update(monitored):
            if lead:
                print(f"early stop at epoch {epoch} (best {stopper.best:.5f})")
            break
    state.model.load_state_dict(best["model"])
    state.load_state_dict(best["train"])
    return state
