"""matmul_ms.p2n: device milliseconds a cloud of the matrix-product
kernels (cuBLAS and CUTLASS GEMMs), Patch2Normal's linear maps."""

from benchmark import readers


def read(rec):
    t = rec["trace"]
    return None if t is None else 1e3 * readers.group_seconds(rec, "matmul") / t["jobs"]
