"""Entry: the GCN-Denoiser mesh cascade of ``ngpd_tpu_torch``,
``meshproc.gcn_denoiser.gcn_denoise_mesh``: per pass the centroid kNN
(the kNN kernel), a 64-face patch for every face, the DGCNN over the
patches in batches (the feature-kNN and edge-block kernels, matrix
products) and guided normal filtering with vertex updates.

A job is one noisy mesh through every pass; its output is the denoised
vertices. The weights are the committed archives the configuration
names (paths from the root of the checkout), read by the program at
set-up and by the reference on its own. The reference is
``benchmark/reference/gcn_mesh.py``; the lower-precision control is that
reference with its products at TF32.

The cascade is chaotic in float32: where two eigenvalues of a patch's
voting tensor lie close, its frame, and so the network's input, turns
with the last bit of the input. A one-step nudge of every input
coordinate moves the reference's output about as far as the program lies
from it, so the comparison holds the program's gap against that spread.
"""

from __future__ import annotations

from pathlib import Path

import torch

from benchmark.counts import gcn as counts
from benchmark.reference import gcn_mesh, numerics

FAR = 1e-4  # a move of about a hundredth of the icosphere(6) edge length
NUDGES = (1, 2)  # the seeds of the nudged inputs that measure the spread


class System:
    def __init__(self, config: dict, traffic: dict, device):
        from ngpd_tpu_torch.config import GNFConfig, PatchConfig
        from ngpd_tpu_torch.learn.weights import load_dgcnn_state_dict
        from ngpd_tpu_torch.models.dgcnn import dgcnn_from_state_dict

        self.config, self.traffic, self.device = config, traffic, device
        passes = config["passes"]
        # As the command line hands them over: the first pass's model, and
        # the later passes' weights as a state dict.
        states = [load_dgcnn_state_dict(Path(config["root"]) / p["weights"]) for p in passes]
        self.model = dgcnn_from_state_dict(states[0]).to(device)
        self.variables2 = states[1] if len(states) > 1 else None
        self.gnfs = [GNFConfig(**p["gnf"]) for p in passes]
        self.patch = PatchConfig(radius_factor=config["radius_factor"],
                                 num_nodes=config["patch_nodes"])
        self.faces = 20 * 4 ** int(traffic["subdiv"])

    def run(self, job: dict):
        """The timed path: one mesh through every pass; its vertices."""
        from ngpd_tpu_torch.meshproc import gcn_denoiser
        from ngpd_tpu_torch.meshproc.trimesh import TriMesh

        out = gcn_denoiser.gcn_denoise_mesh(
            TriMesh(v=job["vertices"], f=job["faces"]), self.model,
            passes=len(self.gnfs), gnf_cfg=self.gnfs[0], patch_cfg=self.patch,
            batch_size=self.config["batch"], variables2=self.variables2,
            gnf_cfg2=self.gnfs[1] if len(self.gnfs) > 1 else None, device=self.device)
        return (out.v,)

    def units(self) -> int:
        """Faces of one job, each through every pass."""
        return self.faces

    def work(self) -> dict:
        return counts.job_work(self.config, self.traffic)

    def counters(self) -> dict:
        from ngpd_tpu_torch.kernels import graph, knn, passes, window

        return {**window.LAUNCHES, **passes.LAUNCHES, **knn.LAUNCHES, **graph.LAUNCHES}


def nudged(v: torch.Tensor, seed: int) -> torch.Tensor:
    """Every coordinate moved one float32 step up or down, the direction
    drawn from ``seed``."""
    gen = torch.Generator(device=v.device).manual_seed(seed)
    up = torch.rand(v.shape, generator=gen, device=v.device) < 0.5
    return torch.where(up, torch.nextafter(v, torch.full_like(v, float("inf"))),
                       torch.nextafter(v, torch.full_like(v, float("-inf"))))


def reference(config: dict, traffic: dict, job: dict, control: bool = False):
    """The plain reference's vertices of one job, then, unless ``control``,
    its vertices for the job's input nudged by one float32 step on each of
    ``NUDGES``: the cascade's own spread. With ``control`` its products at
    TF32 and no spread."""
    dev = job["vertices"].device
    weights = [gcn_mesh.load_weights(Path(config["root"]) / p["weights"], dev)
               for p in config["passes"]]

    def cascade(v):
        return gcn_mesh.cascade(v, job["faces"], weights, [p["gnf"] for p in config["passes"]],
                                config["radius_factor"], config["batch"], config["patch_nodes"])

    with numerics.at_tf32(control), torch.no_grad():
        base = cascade(job["vertices"])
        if control:
            return (base,)
        return (base,) + tuple(cascade(nudged(job["vertices"], s)) for s in NUDGES)


def _moves(a, b):
    return (a.to(b.device) - b).abs().amax(dim=1).double()


def compare(out, ref) -> dict:
    """The gaps of the vertices from the reference's, each vertex's move its
    largest coordinate difference, and against the reference's own spread:
    ``excess`` = (median move / the spread's largest median move)^2 - 1,
    the share of the squared gap that the cascade's float32 sensitivity to
    its input does not explain."""
    d = _moves(out[0], ref[0])
    spread = max(float(_moves(s, ref[0]).median()) for s in ref[1:])
    return {"v_median": float(d.median()), "v_p99": float(torch.quantile(d, 0.99)),
            "v_max": float(d.max()), "far_share": float((d > FAR).double().mean()),
            "spread_median": spread, "excess": (float(d.median()) / spread) ** 2 - 1.0}
