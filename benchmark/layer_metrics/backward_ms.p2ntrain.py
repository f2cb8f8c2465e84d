"""backward_ms.p2ntrain: stream milliseconds a job of Patch2Normal's
training steps' backward, the span ``ngpd.train.backward`` (one a step;
the card's time between its two events, idle inside included), in the
traced slice."""

from benchmark import spans


def read(rec):
    return spans.stage_per_job(rec, "stream_ms", ("ngpd.train.backward",),
                               rec["work"]["steps"])
