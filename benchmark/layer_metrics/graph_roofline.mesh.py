"""graph_roofline.mesh: the least time of a mesh's feature-kNN and
edge-block launches (``benchmark/counts/graph.py``) over their device
time, where the program launched each as often as the work says."""

from benchmark import readers
from benchmark.counts import peaks


def read(rec):
    t, launches = rec["trace"], rec["work"].get("graph")
    if t is None or not launches:
        return None
    for kernel in ("feature_knn", "edge_block"):
        if not readers.counted(rec, kernel, sum(1 for x in launches if x[0] == kernel)):
            return None
    least = sum(peaks.least_seconds(flop, nbytes) for _, flop, nbytes in launches)
    return readers.roofline_percent(least, rec, "feature_knn", "edge_block")
