"""Entry: Patch2Normal's training of ``ngpd_tpu_torch``, the steps that
``learn.train.fit`` takes: ``train_step`` (on the card its graphed
train-mode forward and backward over the edge-block kernel and the
matrix products, the loss ``custom_val_loss``, Adam) on the batches that
a ``PatchDataset`` yields from its training split staged on the device,
the model from the configuration's seeded variables and the optimizer
from ``learn.train.new_state``.

The data set is ``make-dataset``'s work on the job's clean cloud
(``learn.dataset.process_cloud``: ground-truth normals, Gaussian noise
along them drawn from ``data_seed``, the noisy cloud's normals and one MD
patch a point, no balancing), split over the patches as the thesis's
``SimpleDataset`` is (a ``numpy`` permutation from ``data_seed``, the
first 60% train) and taken in by ``PatchDataset.from_arrays``. It is
built the first time the input comes (the warm-up job; the pool holds one
cloud), as the trainer stages its data set once.

A job is ``steps`` optimizer steps at the configuration's batch from one
fixed start, as a run resumed from the same checkpoint takes them: every
job loads the start's weights, BatchNorm statistics, empty Adam moments
and dropout generator again, and takes the epoch's first batches in the
order ``batch_seed`` gives, so every job does the same work and gives the
same result. Its output is the losses, every parameter and every running
statistic after the last step, and every parameter after the first step,
each flattened in the order of the reference's flat Flax names.

The reference (``benchmark/reference/p2n_train.py``) builds its own data
set from the same clean cloud and trains from the same draw with its own
batch and keep-mask draws, and again on the cloud nudged by one float32
step on each of ``NUDGES``, its own spread. ``compare`` is the training
cell's (``gcn_dgcnn_train.compare``): the first loss's relative gap, and
the gaps of the parameters after the first and the last step and of the
running statistics, each over how far the reference moved them from the
start, so a state left at the start reads 1. The lower-precision control
is the reference with every product at TF32.

The MD frames of a flat patch turn with the last bit of their input: a
one-step nudge of the cloud moves the reference's first update about as
far as the update itself, so the nudged runs' numbers are printed with
no limit. The reference's data set is the program's bit for bit (it
divides as the port does), so the step is held over every patch.
"""

from __future__ import annotations

import copy
from itertools import islice

import numpy as np
import torch

from benchmark.counts import p2n_train as counts
# ``compare``, which the harness calls, is the training cell's.
from benchmark.entries.gcn_dgcnn_train import compare, start_state  # noqa: F401
from benchmark.entries.gcn_mesh_cascade import nudged
from benchmark.entries.p2n_normals import load_model
from benchmark.reference import p2n_normals, p2n_train

NUDGES = (1, 2)  # the seeds of the nudged inputs that measure the spread
_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def flax_view(model, key: str) -> torch.Tensor:
    """The port's tensor of a flat Flax name (``params/layer0/lin/kernel``,
    ``batch_stats/layer6_bn/mean``, ...) in the Flax layout: a view of the
    live parameter or statistic, detached, so that it holds no autograd
    node."""
    path, leaf = key.split("/", 1)[1].rsplit("/", 1)
    mod = model.get_submodule(path.replace("/", "."))
    if leaf == "kernel":
        return mod.weight.detach().T
    return getattr(mod, _LEAF[leaf]).detach()


def train_rows(n: int, config: dict) -> np.ndarray:
    """The training split's patches: the first ``split[0]`` of a
    permutation from ``data_seed``."""
    return np.random.default_rng(config["data_seed"]).permutation(n)[
        : int(config["split"][0] * n)]


class System:
    def __init__(self, config: dict, traffic: dict, device):
        from ngpd_tpu_torch.config import PatchConfig
        from ngpd_tpu_torch.learn.dataset import PatchDataset
        from ngpd_tpu_torch.learn.train import new_state

        self.from_arrays = PatchDataset.from_arrays  # a program without it fails here
        self.config, self.traffic, self.device = config, traffic, device
        self.model = load_model(config, device)
        self.state = new_state(self.model, config["learning_rate"], config["dropout_seed"],
                               device)
        self.start = {"model": copy.deepcopy(self.model.state_dict()),
                      "train": copy.deepcopy(self.state.state_dict())}
        keys = list(p2n_normals.draw_variables(config, config["weights_seed"]))
        self.params = [flax_view(self.model, k) for k in keys if k.startswith("params/")]
        self.stats = [flax_view(self.model, k) for k in keys if k.startswith("batch_stats/")]
        self.patch = PatchConfig(num_nodes=config["num_nodes"], patch_k=config["patch_k"],
                                 k_patch_radius=config["k_patch_radius"])
        self.steps, self.batch = int(traffic["steps"]), int(config["batch"])
        self.sets = {}  # id of an input's points -> (the points, its data set)

    def _data(self, job: dict):
        from ngpd_tpu_torch.core.noise import draw_noise
        from ngpd_tpu_torch.learn.dataset import process_cloud

        key = id(job["points"])
        if key not in self.sets:
            pts = job["points"]
            gen = torch.Generator(device=pts.device).manual_seed(int(self.config["data_seed"]))
            arrays = process_cloud(pts, draw_noise(pts.shape[0], gen),
                                   self.config["noise_level"], self.config["noise_type"],
                                   self.patch, device=self.device)
            rows = train_rows(pts.shape[0], self.config)
            self.sets[key] = (pts, self.from_arrays([{k: v[rows] for k, v in arrays.items()}],
                                                    device=self.device))
        return self.sets[key][1]

    def run(self, job: dict):
        """The timed path: ``steps`` optimizer steps from the start; the
        losses, the parameters and running statistics after the last step,
        and the parameters after the first."""
        from ngpd_tpu_torch.learn.train import train_step

        data = self._data(job)
        self.model.load_state_dict(self.start["model"])
        self.state.load_state_dict(self.start["train"])
        loss_key = self.config["loss"]
        losses, first = [], None
        for batch in islice(data.batches(self.batch, seed=self.config["batch_seed"]),
                            self.steps):
            _, metrics = train_step(self.state, batch, loss_key=loss_key)
            losses.append(metrics[loss_key])
            if first is None:
                first = torch.cat([t.reshape(-1) for t in self.params])
        return (torch.stack(losses), torch.cat([t.reshape(-1) for t in self.params]),
                torch.cat([t.reshape(-1) for t in self.stats]), first)

    def units(self) -> int:
        """Point-iterations of one job: each patch (one a point) trained on,
        once a step."""
        return self.steps * self.batch

    def work(self) -> dict:
        return counts.job_work(self.config, self.traffic)

    def counters(self) -> dict:
        from ngpd_tpu_torch.kernels import graph
        from ngpd_tpu_torch.learn import train

        # The graph counter is read where the program has it.
        return {**graph.LAUNCHES, **train.STEPS, **getattr(train, "GRAPHS", {})}


def reference(config: dict, traffic: dict, job: dict, control: bool = False):
    """The plain reference of one job: ``{"start": (parameters,
    statistics), "runs": [(losses, parameters, statistics, first
    parameters), ...]}``, the job's run first, then the same of the job's
    cloud nudged by one float32 step on each of ``NUDGES``. With
    ``control`` the job's run alone, as the program's output, every product
    at TF32."""
    variables = p2n_normals.draw_variables(config, config["weights_seed"])

    def trained(points):
        return p2n_train.train(p2n_train.data_set(points, config), variables, config,
                               int(traffic["steps"]), tf32=control)

    base = trained(job["points"])
    if control:
        return base
    return {"start": start_state(variables, job["points"].device),
            "runs": [base] + [trained(nudged(job["points"], s)) for s in NUDGES]}
