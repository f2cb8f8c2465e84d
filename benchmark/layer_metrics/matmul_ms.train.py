"""matmul_ms.train: device milliseconds a job of the matrix-product
kernels (cuBLAS and CUTLASS GEMMs), the DGCNN's linear maps in the forward
and both products of their backward."""

from benchmark import readers


def read(rec):
    t = rec["trace"]
    return None if t is None else 1e3 * readers.group_seconds(rec, "matmul") / t["jobs"]
