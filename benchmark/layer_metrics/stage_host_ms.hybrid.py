"""stage_host_ms.hybrid: host milliseconds a cloud of the hybrid engine's
two per-point stages, the spans ``ngpd.hybrid.vu_stage`` and
``ngpd.hybrid.update_stage`` (20 of each a cloud), in the traced slice."""

from benchmark import spans

ITERATIONS = 20


def read(rec):
    return spans.stage_per_job(rec, "host_ms", ("ngpd.hybrid.vu_stage",
                                                "ngpd.hybrid.update_stage"), ITERATIONS)
