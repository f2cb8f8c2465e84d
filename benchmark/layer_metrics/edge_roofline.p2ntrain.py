"""edge_roofline.p2ntrain: the least time of a training job's edge-block
launches (the features and indices read once, the (64, 64, 12, 2c) block
written once; ``benchmark/counts/graph.py``) over their device time,
where the program launched the edge block as often as the work says (6 a
step, 384 a job, replays of a CUDA graph counted as ``LAUNCHES`` records
them)."""

from benchmark import readers
from benchmark.counts import peaks


def read(rec):
    launches = [x for x in rec["work"].get("graph", []) if x[0] == "edge_block"]
    if rec["trace"] is None or not launches or not readers.counted(rec, "edge_block",
                                                                   len(launches)):
        return None
    least = sum(peaks.least_seconds(flop, nbytes) for _, flop, nbytes in launches)
    return readers.roofline_percent(least, rec, "edge_block")
