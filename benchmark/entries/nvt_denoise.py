"""Entry: the classical normal-voting denoise of ``ngpd_tpu_torch``, routed
by the size of the cloud as the command line's ``denoise`` routes it: from
``hybrid_min_points`` points on, the hybrid engine
(``core.cuda_fused.denoise_hybrid``: the window kernels K0/K1/K2 and the
per-point torch stages); below, the dense (N, k) pipeline
(``core.pipeline.denoise``, brute-force neighbours over the kNN kernel).

A job is one cloud with its normals, denoised for the mix's iterations;
its output is (positions, normals, classes). The reference is
``benchmark/reference/nvt_hybrid.py`` or ``nvt_dense.py``; the
lower-precision control is that reference with its window and neighbour
sums at TF32.
"""

from __future__ import annotations

import torch

from benchmark.counts import nvt as counts
from benchmark.reference import numerics, nvt_dense, nvt_hybrid

FAR = 1e-4  # a move of a hundredth of the roof's point spacing


class System:
    def __init__(self, config: dict, traffic: dict, device):
        from ngpd_tpu_torch.config import DenoiseConfig

        self.config, self.traffic, self.device = config, traffic, device
        self.n = int(traffic["points"])
        self.iterations = int(traffic["iterations"])
        self.route = route(config, traffic)
        self.cfg = DenoiseConfig(
            feature_k=config["feature_k"], step_k=config["step_k"], angle=config["angle"],
            alphas=tuple(config["alphas"]), d_scale=config["d_scale"],
            class_scale=config["class_scale"], vu_tau=config["vu_tau"],
            vu_damping=config["vu_damping"])
        self.strategy = tuple(config["strategy"])

    def run(self, job: dict):
        """The timed path: one cloud, ``iterations`` iterations."""
        if self.route == "hybrid":
            from ngpd_tpu_torch.core import cuda_fused

            h = self.config["hybrid"]
            return cuda_fused.denoise_hybrid(
                job["points"], job["normals"], self.cfg, strategy=self.strategy,
                iterations=self.iterations, tile=h["tile"], window=h["window"],
                threshold_method=h["threshold_method"], threshold_slack=h["threshold_slack"],
                sub=h["sub"], lagged_nvt1=h["lagged_nvt1"], device=self.device)
        from ngpd_tpu_torch.core import pipeline

        return pipeline.denoise(job["points"], job["normals"], self.cfg, strategy=self.strategy,
                                iterations=self.iterations, neighbor_method="brute",
                                device=self.device)

    def units(self) -> int:
        """Point-iterations of one job."""
        return self.n * self.iterations

    def work(self) -> dict:
        """What one job must do, for the per-layer metrics."""
        return counts.job_work(self.config, self.traffic, self.route)

    def counters(self) -> dict:
        """The program's launch counters."""
        from ngpd_tpu_torch.kernels import graph, knn, passes, window

        return {**window.LAUNCHES, **passes.LAUNCHES, **knn.LAUNCHES, **graph.LAUNCHES}


def route(config: dict, traffic: dict) -> str:
    """The command line's engine for a cloud of the mix's size."""
    return "hybrid" if int(traffic["points"]) >= config["hybrid_min_points"] else "dense"


def reference(config: dict, traffic: dict, job: dict, control: bool = False):
    """The plain reference's (positions, normals, classes) of one job; with
    ``control`` its sums at TF32."""
    cfg = dict(config, strategy=tuple(config["strategy"]))
    it = int(traffic["iterations"])
    with numerics.at_tf32(control), torch.no_grad():
        if route(config, traffic) == "hybrid":
            return nvt_hybrid.denoise(job["points"], job["normals"], cfg, config["hybrid"], it)
        return nvt_dense.denoise(job["points"], job["normals"], cfg, it)


def compare(out, ref) -> dict:
    """The gaps of an output from the reference's: each point's move is its
    largest coordinate difference."""
    d = (out[0].to(ref[0].device) - ref[0]).abs().amax(dim=1).double()
    dn = (out[1].to(ref[1].device) - ref[1]).abs().amax(dim=1).double()
    return {"pos_median": float(d.median()), "pos_p99": float(torch.quantile(d, 0.99)),
            "pos_max": float(d.max()), "far_share": float((d > FAR).double().mean()),
            "normal_median": float(dn.median()),
            "class_share": float((out[2].to(ref[2].device) != ref[2]).double().mean())}
