"""batch_host_ms.p2ntrain: host milliseconds a job of taking the training
batches from the split staged on the device, the span
``ngpd.train.batch`` (one a step), in the traced slice."""

from benchmark import spans


def read(rec):
    return spans.stage_per_job(rec, "host_ms", ("ngpd.train.batch",), rec["work"]["steps"])
