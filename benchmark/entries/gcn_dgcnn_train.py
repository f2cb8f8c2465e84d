"""Entry: GCN-Denoiser's DGCNN training of ``ngpd_tpu_torch``, the steps
that ``learn.train_dgcnn.fit_dgcnn`` takes: ``dgcnn_train_step`` (the
train-mode forward over the feature-kNN and edge-block kernels and the
matrix products, the loss, autograd's backward, Adam) on the batches that
a ``ShardStore`` yields from its train split staged on the device, the
model and optimizer from ``learn.train.new_state``.

A job is ``steps`` optimizer steps at the configuration's batch from one
fixed start, as a run resumed from the same checkpoint takes them: every
job loads the start's weights, BatchNorm statistics, empty Adam moments,
dropout generator and the store's batch order again, so every job does
the same work and gives the same result. Its output is the losses, every
parameter and every running statistic after the last step, and every
parameter after the first step (a 10 MB copy on the card), each flattened
in the order of the reference's flat Flax names.

The weights are drawn from the configuration's ``weights_seed`` by the
reference (``benchmark/reference/gcn_train.py::draw_variables``) and
loaded into the port's ``DGCNN`` through its state dict, as a flat archive
is loaded. The patches of an input are the collector's: one
``extract_mesh_patches`` call on the noisy mesh, the targets the clean
twin's face normals, built the first time the input comes (the warm-up
job where the pool holds one mesh) and put in a store, as the trainer
stages its data set once.

The reference trains from the same draw on its own patches, with its own
batch and keep-mask draws, and again on the mesh nudged by one float32
step on each of ``NUDGES``. Its forward sums in the orders the program's
kernels document (the feature distances channel by channel, as
``csrc/feature_knn.cu`` adds them), so the first loss, taken before any
update, matches bit for bit: ``loss0_rel``, its relative gap, holds a
limit far below what TF32 moves it. The parameters after the first step
(Adam's first update is lr times the gradient's sign) hold the backward
and the update before chaos sets in: ``first_update_rel``. That limit ties the program to those
orders: a sound float32 reorder of the distances breaks feature-kNN ties
otherwise and moves the first loss past it. After the first update the
training is chaotic in float32 (Adam's first step is about the gradient's
sign, and a moved weight changes feature neighbours), so the state after
the last step is held as a whole: ``update_rel`` and ``stats_rel``, the
norm of the parameters' (running statistics') gap from the reference over
the norm of the reference's change from the start. A state left at the
start reads 1 in each, Adam at twice the learning rate about 1, Adam
without its bias correction more (``benchmark/train_faults.py``). ``loss_ratio`` and
the nudged runs' own ``change_gap`` are printed with no limit. The
lower-precision control is the reference with every product at TF32.
"""

from __future__ import annotations

import copy
from itertools import islice

import torch

from benchmark.counts import gcn_train as counts
from benchmark.entries.gcn_mesh_cascade import nudged
from benchmark.reference import gcn_train

NUDGES = (1, 2)  # the seeds of the nudged inputs that measure the spread
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def load_model(config: dict, variables: dict, device):
    """The port's DGCNN of the configuration's widths with the flat Flax
    ``variables``, loaded through its state dict, strictly."""
    from ngpd_tpu_torch.learn.weights import state_dict_from_variables, unflatten_variables
    from ngpd_tpu_torch.models.dgcnn import DGCNN

    tree = unflatten_variables(variables)
    model = DGCNN(k=config["k"], init_dims=config["init_dims"], emb_dims=config["emb_dims"],
                  output_channels=config["head"][-1], dropout=config["dropout"])
    model.load_state_dict(state_dict_from_variables(tree), strict=True)
    return model.to(device)


def flax_view(model, key: str) -> torch.Tensor:
    """The port's tensor of a flat Flax name (``params/conv3/Dense_0/kernel``,
    ``batch_stats/bn7/mean``, ...) in the Flax layout: a view of the live
    parameter or statistic, detached, so that it holds no autograd node."""
    path, leaf = key.split("/", 1)[1].rsplit("/", 1)
    top = path.split("/")[0]  # conv1-7, bn7-10 or linear1-4
    if leaf == "kernel":
        mod = model.get_submodule(f"{top}.0" if top.startswith("conv") else top)
        return mod.weight.detach().flatten(1).T
    if top.startswith("linear"):
        return model.get_submodule(top).bias.detach()
    bn = top.replace("conv", "bn") if path.endswith("BatchNorm_0") else top
    return getattr(model.get_submodule(bn), _BN_LEAF[leaf]).detach()


class System:
    def __init__(self, config: dict, traffic: dict, device):
        from ngpd_tpu_torch.learn.train import new_state

        self.config, self.traffic, self.device = config, traffic, device
        variables = gcn_train.draw_variables(config, config["weights_seed"])
        self.model = load_model(config, variables, device)
        self.state = new_state(self.model, config["learning_rate"], config["dropout_seed"],
                               device)
        self.start = {"model": copy.deepcopy(self.model.state_dict()),
                      "train": copy.deepcopy(self.state.state_dict())}
        self.params = [flax_view(self.model, k) for k in variables if k.startswith("params/")]
        self.stats = [flax_view(self.model, k) for k in variables
                      if k.startswith("batch_stats/")]
        self.steps, self.batch = int(traffic["steps"]), int(config["batch"])
        self.stores = {}  # id of an input's vertices -> (the vertices, store, its start)

    def _store(self, job: dict):
        from ngpd_tpu_torch.config import PatchConfig
        from ngpd_tpu_torch.learn.train_dgcnn import ShardStore
        from ngpd_tpu_torch.meshproc.patches import extract_mesh_patches
        from ngpd_tpu_torch.meshproc.trimesh import TriMesh

        key = id(job["vertices"])
        if key not in self.stores:
            gt, _, _ = TriMesh(v=job["clean"], f=job["faces"]).face_data()
            patches = extract_mesh_patches(
                TriMesh(v=job["vertices"], f=job["faces"]), gt_normals=gt,
                cfg=PatchConfig(radius_factor=self.config["radius_factor"],
                                num_nodes=self.config["patch_nodes"]), device=self.device)
            store = ShardStore.from_patches([patches], self.config["val_fraction"],
                                            self.config["data_seed"], device=self.device)
            self.stores[key] = (job["vertices"], store, store.state_dict())
        return self.stores[key][1:]

    def run(self, job: dict):
        """The timed path: ``steps`` optimizer steps from the start; the
        losses, the parameters and running statistics after the last step,
        and the parameters after the first."""
        from ngpd_tpu_torch.learn.train_dgcnn import dgcnn_train_step

        store, order = self._store(job)
        self.model.load_state_dict(self.start["model"])
        self.state.load_state_dict(self.start["train"])
        store.load_state_dict(order)
        losses, first = [], None
        for batch in islice(store.batches("train", self.batch), self.steps):
            _, metrics = dgcnn_train_step(self.state, batch, alpha=self.config["loss_alpha"],
                                          beta=self.config["loss_beta"])
            losses.append(metrics["loss"])
            if first is None:
                first = torch.cat([t.reshape(-1) for t in self.params])
        return (torch.stack(losses), torch.cat([t.reshape(-1) for t in self.params]),
                torch.cat([t.reshape(-1) for t in self.stats]), first)

    def units(self) -> int:
        """Faces of one job: each patch trained on, once a step."""
        return self.steps * self.batch

    def work(self) -> dict:
        return counts.job_work(self.config, self.traffic)

    def counters(self) -> dict:
        from ngpd_tpu_torch.kernels import graph, knn
        from ngpd_tpu_torch.learn import train

        return {**knn.LAUNCHES, **graph.LAUNCHES, **train.STEPS}


def start_state(variables: dict, device) -> tuple:
    """The start's parameters and running statistics, each flattened and
    concatenated in the order of the flat Flax names, float64."""
    return tuple(torch.cat([torch.as_tensor(v, device=device).reshape(-1) for k, v in
                            variables.items() if k.startswith(kind)]).double()
                 for kind in ("params/", "batch_stats/"))


def reference(config: dict, traffic: dict, job: dict, control: bool = False):
    """The plain reference of one job: ``{"start": (parameters,
    statistics), "runs": [(losses, parameters, statistics, first
    parameters), ...]}``, the
    job's run first, then the same of the job's mesh nudged by one float32
    step on each of ``NUDGES``: its own spread. With ``control`` the job's
    run alone, as the program's output, the network's products at TF32."""
    variables = gcn_train.draw_variables(config, config["weights_seed"])

    def trained(v):
        with torch.no_grad():
            inputs, targets = gcn_train.mesh_patches(v, job["faces"], job["clean"],
                                                     config["radius_factor"],
                                                     config["patch_nodes"])
        return gcn_train.train(inputs, targets, variables, config, int(traffic["steps"]),
                               tf32=control)

    base = trained(job["vertices"])
    if control:
        return base
    return {"start": start_state(variables, job["vertices"].device),
            "runs": [base] + [trained(nudged(job["vertices"], s)) for s in NUDGES]}


def change_gap(a: torch.Tensor, b: torch.Tensor, start: torch.Tensor) -> float:
    """||a - b|| / ||b - start||: the gap of a state from the reference's
    ``b``, over how far the reference moved it from ``start``; a state
    left at the start reads 1."""
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b - start))


def compare(out, ref) -> dict:
    """The numbers of the program's (losses, parameters, statistics, first
    parameters) against the reference's run: ``loss0_rel``, the first
    loss's relative gap; ``first_update_rel``, the ``change_gap`` of the
    parameters after the first step; ``update_rel`` and ``stats_rel``, that
    of the parameters and of the running statistics after the last step;
    ``loss_ratio``, the largest loss gap over the nudged runs' largest; and
    ``nudge_first_rel``, ``nudge_update_rel``, ``nudge_stats_rel``, the
    largest ``change_gap`` of a nudged run: the reference's own spread."""
    p0, s0 = ref["start"]
    loss, params, stats, first = (t.to(p0.device).double() for t in out[:4])
    base, *nudges = [[t.double() for t in run] for run in ref["runs"]]
    loss_gap = float((loss - base[0]).abs().max())
    loss_spread = max(float((n[0] - base[0]).abs().max()) for n in nudges)
    return {"loss0_rel": float((loss[0] - base[0][0]).abs() / base[0][0].abs()),
            "first_update_rel": change_gap(first, base[3], p0),
            "update_rel": change_gap(params, base[1], p0),
            "stats_rel": change_gap(stats, base[2], s0),
            "loss_ratio": loss_gap / max(loss_spread, 1e-30),
            "nudge_first_rel": max(change_gap(n[3], base[3], p0) for n in nudges),
            "nudge_update_rel": max(change_gap(n[1], base[1], p0) for n in nudges),
            "nudge_stats_rel": max(change_gap(n[2], base[2], s0) for n in nudges)}
