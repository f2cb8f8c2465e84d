"""optimizer_host_ms.p2ntrain: host milliseconds a job of the optimizer,
the self time of the span ``ngpd.train.optimizer`` (one a step: zero_grad
and Adam's step, the backward's own span left out), in the traced slice,
where the program's step counter counted every step."""

from benchmark import readers, spans


def read(rec):
    steps = rec["work"]["steps"]
    if rec["trace"] is None or not readers.counted(rec, "train", steps):
        return None
    return spans.stage_per_job(rec, "self_ms", ("ngpd.train.optimizer",), steps)
