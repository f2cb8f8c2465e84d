"""The readers of the program's spans, on recorded states made by hand:
each divides ``prof.recorded()`` by the traced jobs, and reads None with
no trace, with a span that ran fewer times than the job says, and with a
program that records no spans."""

from __future__ import annotations

import pytest

from benchmark import catalog
from ngpd_tpu_torch.utils import prof

MS = 1_000_000  # ns


class _Events:
    """A CUDA event pair that reads ``ms`` between its two markers."""

    def __init__(self, ms):
        self.ms = ms

    def __getitem__(self, i):
        return self

    def elapsed_time(self, other):
        return self.ms


def recorded_state(monkeypatch, spans):
    """A registry holding ``spans``: (name, parent, host ms, stream ms or
    None), one record each, all of one call."""
    reg = prof._Registry()
    t = 0
    for name, parent, host_ms, stream_ms in spans:
        rec = prof._Record(name, None, 1)
        rec.parent = parent
        rec.t0, rec.t1 = t, t + int(host_ms * MS)
        rec.events = None if stream_ms is None else _Events(stream_ms)
        reg.records.append(rec)
        t = rec.t1
    monkeypatch.setattr(prof, "_REGISTRY", reg)


def traced(jobs):
    return {"trace": {"jobs": jobs}}


def hybrid(jobs, iterations=20):
    out = [("ngpd.hybrid", None, 250.0, 260.0)]
    for i in range(jobs * iterations):
        out += [("ngpd.hybrid.vu_stage", "ngpd.hybrid", 1.5, 2.0),
                ("ngpd.hybrid.update_stage", "ngpd.hybrid", 2.5 + (i % 2), 3.0)]
    return out


def dense(jobs):
    out = []
    for _ in range(jobs):
        out += [("ngpd.dense", None, 30.0, 31.0), ("ngpd.dense.neighbors", "ngpd.dense", 5, 6)]
        out += [("ngpd.dense.voting", "ngpd.dense", 4.0, 4.5),
                ("ngpd.dense.steps", "ngpd.dense", 6.0, 6.5)] * 2
    return out


def mesh(jobs, passes=2, builds=2, model_build=True):
    out = []
    for _ in range(jobs):
        out.append(("ngpd.mesh", None, 3400.0, 3400.0))
        if model_build:
            out.append(("ngpd.mesh.model_build", "ngpd.mesh", 30.0, 30.5))
        out += [("ngpd.mesh.adjacency", "ngpd.mesh.patches", 20.0, 21.0)] * builds
        out += [("ngpd.mesh.patches", "ngpd.mesh", 100.0, 120.0),
                ("ngpd.mesh.gnf", "ngpd.mesh", 40.0, 55.0)] * passes
    return out


def read(name, rec):
    return catalog.reader("layer_metrics", name)(rec)


# (reader, recorded spans, traced jobs, the hand-worked value)
CASES = [
    # 20 iterations a cloud, two clouds: 40 x (1.5 + 2.5 or 3.5) / 2.
    ("stage_host_ms.hybrid", hybrid(2), 2, 20 * 1.5 + 10 * 2.5 + 10 * 3.5),
    # Two iterations a cloud: 2 x (4 + 6).
    ("stage_host_ms.dense", dense(3), 3, 20.0),
    # Stream ms: two passes of 55 a mesh.
    ("gnf_ms.mesh", mesh(1), 1, 110.0),
    ("patches_ms.mesh", mesh(2), 2, 240.0),
    # Host ms: two builds of 20 a mesh.
    ("adjacency_ms.mesh", mesh(2), 2, 40.0),
    ("model_build_ms.mesh", mesh(1), 1, 30.0),
]


@pytest.mark.parametrize("name,spans,jobs,value", CASES, ids=[c[0] for c in CASES])
def test_a_reader_divides_the_recorded_spans_by_the_traced_jobs(monkeypatch, name, spans,
                                                                jobs, value):
    recorded_state(monkeypatch, spans)
    assert read(name, traced(jobs)) == pytest.approx(value)


@pytest.mark.parametrize("name,spans,jobs,value", CASES, ids=[c[0] for c in CASES])
def test_a_reader_reads_nothing_without_a_trace_or_spans(monkeypatch, name, spans, jobs,
                                                         value):
    recorded_state(monkeypatch, spans)
    assert read(name, {"trace": None}) is None
    # A program that records no spans, as the port before them.
    monkeypatch.delattr(prof, "recorded")
    assert read(name, traced(jobs)) is None


@pytest.mark.parametrize("name,short", [
    ("stage_host_ms.hybrid", hybrid(2, iterations=19)),  # 38 of 40
    ("stage_host_ms.dense", dense(2)[:-2]),  # one iteration short
    ("gnf_ms.mesh", mesh(2, passes=1)),  # one pass a mesh
    ("patches_ms.mesh", mesh(2, passes=1)),
    ("adjacency_ms.mesh", mesh(1)),  # the cascade's span once for two jobs
    ("model_build_ms.mesh", mesh(1)),
])
def test_a_reader_reads_nothing_where_its_span_ran_short(monkeypatch, name, short):
    recorded_state(monkeypatch, short)
    assert read(name, traced(2)) is None


def test_the_hybrid_and_dense_stages_must_run_exactly_as_often_as_the_job_says(monkeypatch):
    recorded_state(monkeypatch, hybrid(1, iterations=21))
    assert read("stage_host_ms.hybrid", traced(1)) is None
    recorded_state(monkeypatch, mesh(1, passes=3))  # a third pass still reads
    assert read("gnf_ms.mesh", traced(1)) == pytest.approx(165.0)


def test_a_part_that_did_not_run_reads_zero(monkeypatch):
    recorded_state(monkeypatch, mesh(2, builds=0, model_build=False))
    assert read("adjacency_ms.mesh", traced(2)) == 0.0
    assert read("model_build_ms.mesh", traced(2)) == 0.0


def test_stream_readers_need_the_card_s_events(monkeypatch):
    recorded_state(monkeypatch, [(n, p, h, None) for n, p, h, _ in mesh(1)])
    assert read("gnf_ms.mesh", traced(1)) is None
    assert read("patches_ms.mesh", traced(1)) is None
    assert read("adjacency_ms.mesh", traced(1)) == pytest.approx(40.0)
