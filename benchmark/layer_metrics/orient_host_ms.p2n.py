"""orient_host_ms.p2n: host milliseconds a cloud of the normals'
orientation sweeps, the span ``ngpd.normals.orient`` (one a cloud; each
sweep reads back whether the visited set grew), in the traced slice."""

from benchmark import spans


def read(rec):
    return spans.stage_per_job(rec, "host_ms", ("ngpd.normals.orient",), 1)
