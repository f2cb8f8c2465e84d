"""The least work of one training job of Patch2Normal.

Per patch a step: the folded forward of ``counts/p2n.py``
(``flop_per_patch``: each EdgeConv's map as two (c_in, c_out) maps on the
patch's nodes, the prepool map on every node, the post-pool maps and the
head on the pooled vector) and, for each of those maps, the two products
of its backward, the gradient of its weight and the gradient of its
input, each as many operations as the map's forward; the first
EdgeConv's input gradient is left out, since a patch's features are data.
Products only, an FMA counted as two: BatchNorm, activations, the means,
the pool and Adam are not counted.

The graph kernels' launches: per step one edge block per EdgeConv over
the batch, in the forward (its backward is plain torch).
"""

from __future__ import annotations

from . import graph, p2n


def flop_per_patch(config: dict) -> int:
    p, first = int(config["num_nodes"]), list(config["hidden"])[0]
    first_input_grad = 2 * (2 * p * int(config["input_size"]) * first)
    return 3 * p2n.flop_per_patch(config) - first_input_grad


def step_edge_launches(config: dict) -> list:
    """(kernel, operations, bytes) of the edge-block launches of one step."""
    b, p, k = int(config["batch"]), int(config["num_nodes"]), int(config["patch_k"])
    convs = int(config["edgeconvs"])
    ins = [int(config["input_size"])] + list(config["hidden"])[:convs - 1]
    return [("edge_block",) + graph.edge_block(b, p, c, k) for c in ins]


def job_work(config: dict, traffic: dict) -> dict:
    """A job's operations (``steps`` steps of ``batch`` patches), its step
    count and its graph-kernel launches."""
    steps = int(traffic["steps"])
    return {"flop": float(steps * int(config["batch"]) * flop_per_patch(config)),
            "steps": steps, "graph": step_edge_launches(config) * steps}
