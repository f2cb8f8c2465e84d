"""window_roofline.hybrid: the least time of a cloud's K0, K1 and K2
launches (``benchmark/counts/nvt.py``) over their device time, where the
program launched each as often as the work says."""

from benchmark import readers
from benchmark.counts import peaks


def read(rec):
    if rec["trace"] is None or not rec["work"].get("window"):
        return None
    least = 0.0
    for kernel, launches, flop, nbytes in rec["work"]["window"]:
        if not readers.counted(rec, kernel, launches):
            return None
        least += launches * peaks.least_seconds(flop, nbytes)
    return readers.roofline_percent(least, rec, "k0", "k1", "k2")
