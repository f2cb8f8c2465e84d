"""patches_ms.mesh: stream milliseconds a mesh of the 64-face patch
extraction, the span ``ngpd.mesh.patches`` (the card's time between its
two events, idle inside included; at least 2 a mesh), in the traced
slice."""

from benchmark import spans

PASSES = 2


def read(rec):
    return spans.stage_per_job(rec, "stream_ms", ("ngpd.mesh.patches",), PASSES, exact=False)
