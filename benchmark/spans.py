"""What the readers of the program's spans share.

``ngpd_tpu_torch.utils.prof.span`` records the port's named stages only
while a ``torch.profiler`` session records, and starts its records afresh
at the first recorded span after unrecorded ones: after a ``--trace 1``
run, ``prof.recorded()`` holds the traced slice's spans, summed by name.
A program without spans (no ``recorded``), a run without a trace and a
span that ran other than the job says all read None.
"""

from __future__ import annotations


def _spans(rec):
    if rec["trace"] is None:
        return None
    from ngpd_tpu_torch.utils import prof

    recorded = getattr(prof, "recorded", None)
    return None if recorded is None else recorded()["spans"]


def stage_per_job(rec, key: str, names, runs: int, exact: bool = True):
    """``key`` ("host_ms" or "stream_ms") of the spans ``names``, summed, a
    traced job; where each ran ``runs`` times a job (at least, where not
    ``exact``)."""
    spans = _spans(rec)
    if spans is None:
        return None
    jobs = rec["trace"]["jobs"]
    got = [spans.get(n) for n in names]
    for s in got:
        if s is None or s[key] is None:
            return None
        if s["count"] < runs * jobs or (exact and s["count"] != runs * jobs):
            return None
    return sum(s[key] for s in got) / jobs


def part_per_job(rec, key: str, name: str, root: str):
    """``key`` of the span ``name`` a traced job, where the root span
    ``root`` ran once a job; 0 where ``name`` ran in none of them."""
    spans = _spans(rec)
    if spans is None:
        return None
    jobs = rec["trace"]["jobs"]
    if spans.get(root, {}).get("count") != jobs:
        return None
    s = spans.get(name)
    return 0.0 if s is None else s[key] / jobs
