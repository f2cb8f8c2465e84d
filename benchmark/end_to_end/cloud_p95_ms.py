"""cloud_p95_ms: the 95th percentile of every job's latency in the window,
each job timed from its call until its result is synchronized."""

from benchmark import readers


def read(rec):
    return readers.p95_ms(rec)
