"""edge_roofline.p2n: the least time of a cloud's edge-block launches (the
features and indices read once, the (b, 64, 12, 2c) block written once;
``benchmark/counts/graph.py``) over their device time, where the program
launched the edge block as often as the work says (600 a 102,400-point
cloud)."""

from benchmark import readers
from benchmark.counts import peaks


def read(rec):
    launches = [x for x in rec["work"].get("graph", []) if x[0] == "edge_block"]
    if rec["trace"] is None or not launches or not readers.counted(rec, "edge_block",
                                                                   len(launches)):
        return None
    least = sum(peaks.least_seconds(flop, nbytes) for _, flop, nbytes in launches)
    return readers.roofline_percent(least, rec, "edge_block")
