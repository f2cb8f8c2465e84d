"""The least work of one training job of GCN-Denoiser's DGCNN.

Per patch a step: the folded forward of ``counts/gcn.py``
(``dgcnn_flop_per_patch``: every edge convolution's first map as two
(c_in, c_out) maps on each node, the 1x1 map to emb_dims on each node, the
head on the pooled vector) and, for each of those maps, the two products
of its backward, the gradient of its weight and the gradient of its
input, each as many operations as the map's forward; the first edge
convolution's input gradient is left out, since a patch's features are
data. Products only, an FMA counted as two: BatchNorm, activations, the
maxima, the feature kNN and Adam are not counted.
"""

from __future__ import annotations

from . import gcn, graph


def flop_per_patch(p: int = 64, init_dims: int = 17, emb_dims: int = 1024,
                   channels=gcn.EDGE_CHANNELS, head=gcn.HEAD) -> int:
    forward = gcn.dgcnn_flop_per_patch(p, init_dims, emb_dims, channels, head)
    first_input_grad = 2 * (2 * p * init_dims * channels[0])
    return 3 * forward - first_input_grad


def step_graph_launches(config: dict) -> list:
    """(kernel, operations, bytes) of the graph-kernel launches of one
    step's forward over a batch: every edge convolution builds its block
    over the patch's neighbour rows (the first ``fixed_graph_convs``) or
    over the k nearest in feature space, searched first."""
    b, p, k = int(config["batch"]), int(config["patch_nodes"]), int(config["k"])
    out = []
    ins = (int(config["init_dims"]),) + tuple(config["edge_channels"][:-1])
    for i, c in enumerate(ins):
        if i < int(config["fixed_graph_convs"]):
            out.append(("edge_block",) + graph.edge_block(b, p, c, int(config["neighbour_rows"])))
        else:
            out.append(("feature_knn",) + graph.feature_knn(b, p, c, k))
            out.append(("edge_block",) + graph.edge_block(b, p, c, k))
    return out


def job_work(config: dict, traffic: dict) -> dict:
    """A job's operations (``steps`` steps of ``batch`` patches), its step
    count and its graph-kernel launches."""
    steps = int(traffic["steps"])
    per_patch = flop_per_patch(config["patch_nodes"], config["init_dims"], config["emb_dims"],
                               tuple(config["edge_channels"]), tuple(config["head"]))
    return {"flop": float(steps * int(config["batch"]) * per_patch), "steps": steps,
            "graph": step_graph_launches(config) * steps}
