"""The least work of the GCN-Denoiser cascade on one mesh.

The DGCNN's operations (``dgcnn_flop_per_patch``), products only, an FMA
counted as two: every edge convolution's first linear map in its folded
form, (W_a - W_b) x_i + W_b x_j, two (c_in, c_out) maps on each node of
the patch rather than one (2 c_in, c_out) map on each of its K edges; the
1x1 convolution to emb_dims on every node; the head's four linear maps on
the pooled 2 emb_dims vector. Per job: one patch a face, every pass.

The kernels' launches per job: ``passes`` centroid kNN searches (F points,
k = patch nodes); per DGCNN batch one feature kNN on the input of each
feature-space convolution and one edge block per convolution.
"""

from __future__ import annotations

from . import graph, knn

EDGE_CHANNELS = (64, 64, 128, 256, 256, 256)
FIXED_CONVS, FIXED_K = 3, 3
HEAD = (512, 256, 64, 3)


def dgcnn_flop_per_patch(p: int = 64, init_dims: int = 17, emb_dims: int = 1024,
                         channels=EDGE_CHANNELS, head=HEAD) -> int:
    ins = (init_dims,) + tuple(channels[:-1])
    convs = sum(2 * (2 * p * ci * co) for ci, co in zip(ins, channels))
    emb = 2 * p * sum(channels) * emb_dims
    widths = (2 * emb_dims,) + tuple(head)
    return convs + emb + sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def graph_launches(faces: int, batch: int, p: int, k: int) -> list:
    """(kernel, operations, bytes) of every graph-kernel launch of one
    pass."""
    out = []
    ins = (17,) + EDGE_CHANNELS[:-1]
    for b0 in range(0, faces, batch):
        b = min(batch, faces - b0)
        for i, c in enumerate(ins):
            kk = FIXED_K if i < FIXED_CONVS else k
            if i >= FIXED_CONVS:
                out.append(("feature_knn",) + graph.feature_knn(b, p, c, k))
            out.append(("edge_block",) + graph.edge_block(b, p, c, kk))
    return out


def job_work(config: dict, traffic: dict) -> dict:
    faces = 20 * 4 ** int(traffic["subdiv"])
    passes = len(config["passes"])
    p = config["patch_nodes"]
    per_patch = dgcnn_flop_per_patch(p, emb_dims=config["emb_dims"])
    searches = [(faces, p)] * passes
    return {"flop": float(passes * faces * per_patch),
            "knn": searches,
            "knn_bytes": float(sum(knn.search_bytes(n, k) for n, k in searches)),
            "graph": graph_launches(faces, config["batch"], p, config["k"]) * passes}
