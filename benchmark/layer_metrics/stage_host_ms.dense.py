"""stage_host_ms.dense: host milliseconds a cloud of the dense pipeline's
voting (both filtered NVTs, the VU smoothing, the classes) and steps (the
class deltas, the three steps, the select), the spans ``ngpd.dense.voting``
and ``ngpd.dense.steps`` (2 of each a cloud), in the traced slice."""

from benchmark import spans

ITERATIONS = 2


def read(rec):
    return spans.stage_per_job(rec, "host_ms", ("ngpd.dense.voting", "ngpd.dense.steps"),
                               ITERATIONS)
