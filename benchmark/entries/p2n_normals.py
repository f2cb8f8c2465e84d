"""Entry: Patch2Normal's learned normals of ``ngpd_tpu_torch``,
``learn.predict.predict_cloud_normals`` with its defaults, as the
``predict-normals`` command calls it on a cloud without normals: the
12-NN search and PVT normals, their orientation sweeps, the MD selection
(16-NN and 64-NN searches, the kNN kernel), the frames and node
features, the intra-patch 12-NN, and the model in batches of 1,024 patches
(six EdgeConvs over the edge-block kernel and matrix products, the
prepool, pool, post-pool and head).

A job is one noisy cloud; its output is the (N, 3) unit normals. The
weights are drawn from the configuration's ``weights_seed`` as the flat
Flax variables that ``--ckpt`` reads from a file
(``benchmark/reference/p2n_normals.py::draw_variables``), loaded as the
command loads them; the reference takes the same dict. The
lower-precision control is the reference with the model's products at
TF32.

The normals are chaotic in float32: a patch frame whose two small
eigenvalues lie close turns with the last bit of the input, and with it
the model's input and the normal it gives. So the program's moves from the
reference are read against the reference's own moves under a one-step
nudge of every input coordinate, on two nudges (``median_ratio``,
``max_ratio``, as ``ngpd_tpu_torch/bench.py::within_spread``), and over
the points that neither nudge moves by more than ``STABLE`` (``stable_p99``,
``stable_max``). A point's move is its largest coordinate gap, sign
included, so an orientation flip counts. At 102,400 points a nudge moves
over half the normals by more than 1e-3 and flips some (its largest move
reads about 2), so the largest move cannot tell the TF32 control from the
program and ``max_ratio`` has no limit; the median ratio has one far
below the point track's factor of 2, and the stable points' numbers one
each (PERF.md §2).
"""

from __future__ import annotations

import torch

from benchmark.counts import p2n as counts
from benchmark.entries.gcn_mesh_cascade import nudged
from benchmark.reference import numerics, p2n_normals

NUDGES = (1, 2)  # the seeds of the nudged inputs that measure the spread
STABLE = 1e-4  # a point whose normal neither nudge moves farther is stable


def model_config(config: dict):
    """The port's ``ModelConfig`` of the configuration's widths."""
    from ngpd_tpu_torch.config import ModelConfig

    return ModelConfig(
        input_size=config["input_size"], output_size=config["output_size"],
        num_edgeconv=config["edgeconvs"], num_dynamic_edgeconv=config["dynamic_edgeconvs"],
        num_prepool=config["prepool"], hidden=tuple(config["hidden"]),
        leaky_slope=config["leaky_slope"], patch_size=config["num_nodes"],
        patch_k=config["patch_k"])


def load_model(config: dict, device):
    """The port's Patch2Normal with the configuration's seeded variables,
    loaded as ``--ckpt`` loads a flat archive (``load_dgcnn_npz``) without
    the file read: the nested variables, then the state dict, strictly."""
    from ngpd_tpu_torch.learn.weights import (patch2normal_state_dict_from_variables,
                                              unflatten_variables)
    from ngpd_tpu_torch.models.patch2normal import Patch2NormalModel

    tree = unflatten_variables(p2n_normals.draw_variables(config, config["weights_seed"]))
    tree.setdefault("batch_stats", {})
    model = Patch2NormalModel(model_config(config))
    model.load_state_dict(patch2normal_state_dict_from_variables(tree), strict=True)
    return model.eval().to(device)


class System:
    def __init__(self, config: dict, traffic: dict, device):
        from ngpd_tpu_torch.config import PatchConfig

        self.config, self.traffic, self.device = config, traffic, device
        self.model = load_model(config, device)
        self.patch = PatchConfig(num_nodes=config["num_nodes"], patch_k=config["patch_k"],
                                 k_patch_radius=config["k_patch_radius"])
        self.points = int(traffic["points"])

    def run(self, job: dict):
        """The timed path: one cloud's normals, estimated first."""
        from ngpd_tpu_torch.learn.predict import predict_cloud_normals

        return (predict_cloud_normals(self.model, job["points"], patch_cfg=self.patch,
                                      batch_size=self.config["batch"], device=self.device),)

    def units(self) -> int:
        """Points of one job."""
        return self.points

    def work(self) -> dict:
        return counts.job_work(self.config, self.traffic)

    def counters(self) -> dict:
        from ngpd_tpu_torch.core import normals
        from ngpd_tpu_torch.kernels import graph, knn, passes, window

        # The sweep counter is read where the program has it.
        return {**window.LAUNCHES, **passes.LAUNCHES, **knn.LAUNCHES, **graph.LAUNCHES,
                **getattr(normals, "SWEEPS", {})}


def reference(config: dict, traffic: dict, job: dict, control: bool = False):
    """The plain reference's normals of one job, then, unless ``control``,
    its normals for the job's input nudged by one float32 step on each of
    ``NUDGES``: its own spread. With ``control`` the model's products at
    TF32 and no spread."""
    variables = p2n_normals.draw_variables(config, config["weights_seed"])

    def normals(p):
        return p2n_normals.predict(p, variables, config)

    with numerics.at_tf32(control):
        base = normals(job["points"])
        if control:
            return (base,)
        return (base,) + tuple(normals(nudged(job["points"], s)) for s in NUDGES)


def _moves(a, b):
    return (a.to(b.device) - b).abs().amax(dim=1).double()


def compare(out, ref) -> dict:
    """The normals' moves from the reference's: ``median_ratio`` and
    ``max_ratio``, the median and the largest move over the largest of the
    nudged runs' (``within_spread``'s ratios); ``stable_p99`` and
    ``stable_max``, the 99th percentile and the largest of the moves over
    the points that no nudge moved by more than ``STABLE``
    (``stable_share`` of them)."""
    d = _moves(out[0], ref[0])
    spreads = [_moves(s, ref[0]) for s in ref[1:]]
    spread_median = max(float(s.median()) for s in spreads)
    spread_max = max(float(s.max()) for s in spreads)
    stable = torch.stack(spreads).amax(dim=0) <= STABLE
    on_stable = d[stable]
    return {"median": float(d.median()), "max": float(d.max()),
            "spread_median": spread_median, "spread_max": spread_max,
            "median_ratio": float(d.median()) / max(spread_median, 1e-30),
            "max_ratio": float(d.max()) / max(spread_max, 1e-30),
            "stable_share": float(stable.double().mean()),
            "stable_p99": (float(torch.quantile(on_stable, 0.99)) if on_stable.numel()
                           else float("inf")),
            "stable_max": float(on_stable.max()) if on_stable.numel() else float("inf")}
