"""epilogue_ms.mesh: device milliseconds a mesh of the DGCNN's epilogue
kernel (BatchNorm, LeakyReLU and the max over neighbours after each
product; the kernels whose name holds ``dgcnn_epilogue``), where the
program launched it once for each edge conv's product and once for
conv7's, seven times a DGCNN batch (560 a mesh)."""

from benchmark import readers
from benchmark.counts import gcn

KERNEL = "dgcnn_epilogue"


def read(rec):
    t = rec["trace"]
    edges = sum(1 for x in rec["work"].get("graph", []) if x[0] == "edge_block")
    # Six edge blocks a batch, each product followed by an epilogue, and conv7's.
    per_job = edges + edges // len(gcn.EDGE_CHANNELS)
    if t is None or not edges or not readers.counted(rec, KERNEL, per_job):
        return None
    return 1e3 * sum(s for name, s in t["by_name"].items() if KERNEL in name) / t["jobs"]
