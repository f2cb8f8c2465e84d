"""The least work of the DGCNN's graph kernels, per launch over a batch of
``b`` patches of ``p`` nodes.

Feature kNN (k nearest in a c-wide feature space, self included): the
features read once, each node's k indices (4 bytes) written once; an FMA
(2 operations) for every channel of every unordered pair of nodes, the
least a distance in the Gram form ||x_i||^2 + ||x_j||^2 - 2 x_i.x_j needs.

Edge block ([x_j - x_i, x_i] for the K neighbours of each node): the
features and the K indices (4 bytes) read once, the (b, p, K, 2c) block
written once, one subtraction an edge and channel.
"""

F32 = 4
IDX = 4


def feature_knn(b: int, p: int, c: int, k: int) -> tuple[float, float]:
    """(operations, bytes)."""
    return b * (p * (p - 1) // 2) * c * 2.0, float(b * p * c * F32 + b * p * k * IDX)


def edge_block(b: int, p: int, c: int, kk: int) -> tuple[float, float]:
    """(operations, bytes)."""
    return float(b * p * kk * c), float(b * p * c * F32 + b * p * kk * IDX
                                        + b * p * kk * 2 * c * F32)
