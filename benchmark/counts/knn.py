"""The least work of a k-nearest-neighbour search: its points read once
(3 float32 coordinates each; the queries are the points here) and each
query's k (distance, index) pairs written once, 4 bytes each. No
operation is counted: how many distances a search must evaluate depends on
how it prunes, and a share of the least time must never pass 100%."""

COORD_BYTES = 12
PAIR_BYTES = 8


def search_bytes(points: int, k: int) -> int:
    return points * COORD_BYTES + points * k * PAIR_BYTES
