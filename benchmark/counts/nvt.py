"""The least work of the normal-voting denoise, fixed by the shapes: each
point's feature_k and step_k nearest neighbours (the windowed engine's
thresholds keep at least that many, so these are lower counts), and the
sums that every correct implementation accumulates over them.

Per (point, feature neighbour) of a filtered normal voting tensor
(``NVT_PAIR``): the offset p_j - p_i, its dot with n_j, its squared length,
the angle test and the six sums of n_j n_j^T (the products are per
neighbour, not per pair, so only the additions count). Per (point, step
neighbour) (``STEP_PAIR``): the offset and squared length for the mask and
the sums every step system needs, s6, b_nv, sv and the degree; the edge
step adds the 18 sums of its projected system, the flat step its
bilateral weight (||n_i - n_j||^2, the exponent's products, the product of
the two factors) and its two sums, the "new" step its 12 sums and its
weight. The eigensolves and 3x3 solves per point are left out.

The window kernels' bytes: each input row read once and each output row
written once, 4 bytes an element, over the real points (padding is the
implementation's): K0 reads the positions and writes the two thresholds
and the 6-NN sum and count; K1 reads positions, normals and the feature
threshold and writes the six NVT sums; K2 reads the post-VU pack (positions,
normals, both thresholds) and writes every sum of the update.
"""

from __future__ import annotations

from . import knn

NVT_PAIR = 3 + 5 + 5 + 1 + 6
STEP_BASE = 3 + 5 + 6 + 3 + 3 + 1
STEP_EXTRA = {"flat": 8 + 4 + 2 + 2 + 1, "edge": 18, "new": 12 + 5 + 3,
              "feature": 0, "corner": 0, "dummy": 0}
K2_ROWS = {"flat": 2, "edge": 18, "new": 12}


def step_pair(strategy) -> int:
    return STEP_BASE + sum(STEP_EXTRA[s] for s in set(strategy))


def k2_out_rows(strategy) -> int:
    nd = sum(1 for s in strategy if s in ("flat", "new"))
    return 6 + 6 + 3 + 3 + sum(K2_ROWS.get(s, 0) for s in set(strategy)) + 1 + nd


def job_work(config: dict, traffic: dict, route: str) -> dict:
    """``flop``: the job's least operations; ``window``: the K0/K1/K2
    launches' (kernel, launches, operations, bytes); ``knn``: the searches
    a job must make, as (points, k)."""
    n, it = int(traffic["points"]), int(traffic["iterations"])
    fk, sk = config["feature_k"], config["step_k"]
    strategy = config["strategy"]
    nvt = fk * NVT_PAIR
    step = sk * step_pair(strategy)
    if route == "hybrid":
        lagged = config["hybrid"]["lagged_nvt1"]
        k1_launches = 1 if lagged else it
        flop = n * (it * (nvt + step) + (nvt if lagged else 0))
        window = [("k0", 1, 0.0, 4.0 * n * (3 + 4)),
                  ("k1", k1_launches, float(n * nvt), 4.0 * n * (7 + 6)),
                  ("k2", it, float(n * (nvt + step)), 4.0 * n * (8 + k2_out_rows(strategy)))]
        return {"flop": float(flop), "window": window, "knn": []}
    flop = n * it * (2 * nvt + step)
    searches = [(n, 6)] + [(n, k) for _ in range(it) for k in (fk, sk)]
    return {"flop": float(flop), "window": [], "knn": searches,
            "knn_bytes": float(sum(knn.search_bytes(p, k) for p, k in searches))}
