"""The least work of Patch2Normal's normals of one cloud.

The model's operations (``flop_per_patch``), products only, an FMA
counted as two. An EdgeConv's linear map precedes the mean over the
node's edges, so it folds exactly: mean_j W [x_i, x_j - x_i] =
(W_a - W_b) x_i + W_b mean_j x_j, two (c_in, c_out) maps on each node of
the patch instead of one (2 c_in, c_out) map on each of its K edges. Then
the prepool map on every node, and the post-pool maps and the head on the
pooled vector. The orientation, frames and selections are left out.
Per job: one patch a point.

The kernels' launches per job: three kNN searches of the cloud (the 12
nearest other points for the normals, the 16 and the 64 nearest for the
MD selection), and per batch of patches one edge block per EdgeConv.
"""

from __future__ import annotations

from . import graph, knn


def flop_per_patch(config: dict) -> int:
    """Operations of one patch, the EdgeConvs folded."""
    p = int(config["num_nodes"])
    hidden, convs = list(config["hidden"]), int(config["edgeconvs"])
    ins = [int(config["input_size"])] + hidden[:convs - 1]
    flop = sum(2 * (2 * p * ci * co) for ci, co in zip(ins, hidden[:convs]))
    width, i = sum(hidden[:convs]), convs
    for _ in range(int(config["prepool"])):
        flop += 2 * p * width * hidden[i]
        width, i = hidden[i], i + 1
    width *= 2
    for co in hidden[i:] + [int(config["output_size"])]:
        flop += 2 * width * co
        width = co
    return flop


def edge_launches(points: int, config: dict) -> list:
    """(kernel, operations, bytes) of every edge-block launch of one job."""
    p, k, batch = int(config["num_nodes"]), int(config["patch_k"]), int(config["batch"])
    convs = int(config["edgeconvs"])
    ins = [int(config["input_size"])] + list(config["hidden"])[:convs - 1]
    return [("edge_block",) + graph.edge_block(min(batch, points - b0), p, c, k)
            for b0 in range(0, points, batch) for c in ins]


def job_work(config: dict, traffic: dict) -> dict:
    n = int(traffic["points"])
    searches = [(n, int(config["normal_k"])), (n, int(config["feature_k"])),
                (n, int(config["num_nodes"]))]
    return {"flop": float(n * flop_per_patch(config)),
            "knn": searches,
            "knn_bytes": float(sum(knn.search_bytes(q, k) for q, k in searches)),
            "graph": edge_launches(n, config)}
