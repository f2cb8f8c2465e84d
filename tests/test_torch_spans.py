"""The spans of ``ngpd_tpu_torch/utils/prof.py``: named stages of the
port's layers, recorded only while a ``torch.profiler`` session records.

Off, a span is a flag read and a shared no-op object. On, it is a user
annotation on the profiler's clock and a record with its parent, its
root's call id and its host times; ``recorded()`` sums the records by
name. The entry points' spans are counted on small CPU runs of the dense
pipeline, the hybrid engine, the mesh cascade and the learned normals.
"""

import contextlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ngpd_tpu_torch.config import DenoiseConfig, ModelConfig, PatchConfig
from ngpd_tpu_torch.core import normals as tnormals
from ngpd_tpu_torch.core.cuda_fused import denoise_hybrid
from ngpd_tpu_torch.core.noise import draw_noise
from ngpd_tpu_torch.core.pipeline import denoise
from ngpd_tpu_torch.learn.predict import predict_cloud_normals
from ngpd_tpu_torch.meshproc.gcn_denoiser import gcn_denoise_mesh
from ngpd_tpu_torch.meshproc.synthetic import icosphere
from ngpd_tpu_torch.meshproc.trimesh import add_mesh_noise
from ngpd_tpu_torch.models.dgcnn import DGCNN
from ngpd_tpu_torch.models.patch2normal import init_patch2normal
from ngpd_tpu_torch.ops.knn import knn
from ngpd_tpu_torch.utils import prof

from fixtures import sphere_cloud

torch.set_num_threads(2)


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _unrecorded():
    """Run a span with nothing recording, so that the next recorded one
    starts the records afresh."""
    with prof.span("unrecorded"):
        pass


def _counts():
    return {k: v["count"] for k, v in prof.recorded()["spans"].items()}


def _records():
    """The registry's closed spans, in the order they opened."""
    return [r for r in prof._REGISTRY.records if r.t1]


def _took(r):
    return r.t1 - r.t0


def _self(r):
    return r.t1 - r.t0 - r.child_ns


def test_spans_record_nothing_while_no_profiler_records():
    _unrecorded()
    with _recording():
        with prof.span("a"):
            pass
    before = _records()
    with prof.span("b"):
        with prof.span("c"):
            pass
    assert prof.span("b") is prof.span("c")  # one shared no-op object
    assert _records() == before
    assert [r.name for r in before] == ["a"]


def test_a_span_is_a_user_annotation_on_the_profiler_s_clock():
    _unrecorded()
    with _recording() as p:
        with prof.span("ngpd.test.outer"):
            with prof.span("ngpd.test.inner"):
                torch.ones(64).sum()
    events = {e.name: e for e in p.events() if e.name.startswith("ngpd.test.")}
    assert set(events) == {"ngpd.test.outer", "ngpd.test.inner"}
    for e in events.values():
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert e.is_user_annotation
    outer, inner = events["ngpd.test.outer"], events["ngpd.test.inner"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end


def test_self_time_excludes_the_children():
    _unrecorded()
    with _recording():
        with prof.span("root"):
            time.sleep(0.002)
            with prof.span("child"):
                time.sleep(0.01)
            with prof.span("child"):
                with prof.span("grandchild"):
                    time.sleep(0.005)
    recs = {}
    for r in _records():
        recs.setdefault(r.name, []).append(r)
    (root,), children, (grand,) = recs["root"], recs["child"], recs["grandchild"]
    assert _self(root) == _took(root) - sum(_took(c) for c in children)
    assert _self(children[1]) == _took(children[1]) - _took(grand)
    assert _self(grand) == _took(grand)
    assert _self(root) >= 2_000_000 and _self(root) < _took(root) - 15_000_000
    totals = prof.recorded()["spans"]
    assert totals["child"]["count"] == 2
    assert totals["root"]["self_ms"] == pytest.approx(_self(root) / 1e6)
    assert totals["child"]["host_ms"] == pytest.approx(sum(_took(c) for c in children) / 1e6)
    assert totals["root"]["stream_ms"] is None  # no card, no events


def test_children_carry_the_root_s_call_and_their_parent_s_name():
    _unrecorded()
    with _recording():
        for _ in range(2):
            with prof.span("root"):
                with prof.span("mid"):
                    with prof.span("leaf"):
                        pass
                with prof.span("leaf"):
                    pass
    recs = _records()
    assert [(r.name, r.parent) for r in recs[:4]] == [
        ("root", None), ("mid", "root"), ("leaf", "mid"), ("leaf", "root")]
    first, second = recs[:4], recs[4:]
    assert len({r.call for r in first}) == 1 and len({r.call for r in second}) == 1
    assert first[0].call != second[0].call


def test_records_start_afresh_after_unrecorded_spans():
    _unrecorded()
    with _recording():
        with prof.span("first"):
            pass
    with _recording():  # no span ran in between: the stretch goes on
        with prof.span("second"):
            pass
    assert [r.name for r in _records()] == ["first", "second"]
    _unrecorded()
    assert [r.name for r in _records()] == ["first", "second"]
    with _recording():
        with prof.span("third"):
            pass
    assert [r.name for r in _records()] == ["third"]
    assert prof.recorded()["dropped"] == 0


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(prof, "MAX_RECORDS", 3)
    _unrecorded()
    with _recording():
        with prof.span("root"):
            for _ in range(4):
                with prof.span("child"):
                    pass
    out = prof.recorded()
    assert out["dropped"] == 2
    assert out["spans"]["child"]["count"] == 2 and out["spans"]["root"]["count"] == 1
    assert len(_records()) == 3
    _unrecorded()
    with _recording():
        with prof.span("again"):
            pass
    assert prof.recorded()["dropped"] == 0


def test_dense_pipeline_records_its_stages():
    pts, nrm = sphere_cloud(600, seed=3)
    _unrecorded()
    with _recording():
        denoise(pts, nrm, DenoiseConfig(feature_k=12, step_k=6), iterations=2, device="cpu")
    assert _counts() == {"ngpd.dense": 1, "ngpd.dense.step_threshold": 1,
                         "ngpd.dense.neighbors": 2, "ngpd.dense.voting": 2,
                         "ngpd.dense.steps": 2}
    parents = {r.name: r.parent for r in _records()}
    assert parents["ngpd.dense.voting"] == "ngpd.dense"
    assert parents["ngpd.dense.steps"] == "ngpd.dense"


def test_hybrid_engine_records_its_stages():
    pts, nrm = sphere_cloud(512, seed=9)
    pts = pts + np.random.default_rng(10).normal(scale=0.03, size=pts.shape).astype(np.float32)
    _unrecorded()
    with _recording():
        denoise_hybrid(pts, nrm, iterations=3, tile=128, window=128, lagged_nvt1=True,
                       device="cpu")
    assert _counts() == {"ngpd.hybrid": 1, "ngpd.hybrid.prologue": 1,
                         "ngpd.hybrid.vu_stage": 3, "ngpd.hybrid.update_stage": 3,
                         "ngpd.hybrid.unsort": 1}
    assert {r.parent for r in _records() if r.name != "ngpd.hybrid"} == {"ngpd.hybrid"}


def test_mesh_cascade_records_its_stages():
    clean = icosphere(subdiv=1)
    noisy = add_mesh_noise(clean, draw_noise(clean.num_vertices,
                                             torch.Generator().manual_seed(0)), 0.3)
    model = DGCNN(emb_dims=64).eval()
    _unrecorded()
    with _recording():
        gcn_denoise_mesh(noisy, model, passes=2, variables2=model.state_dict(),
                         batch_size=64, device="cpu")
    # The adjacency is built once a kind (face-face for the patches,
    # vertex-face for the filter) and kept for the second pass.
    assert _counts() == {"ngpd.mesh": 1, "ngpd.mesh.model_build": 1,
                         "ngpd.mesh.centroid_knn": 2, "ngpd.mesh.patches": 2,
                         "ngpd.mesh.adjacency": 2, "ngpd.mesh.dgcnn": 2,
                         "ngpd.mesh.gnf": 2}
    parents = {(r.name, r.parent) for r in _records()}
    assert ("ngpd.mesh.adjacency", "ngpd.mesh.patches") in parents
    assert ("ngpd.mesh.adjacency", "ngpd.mesh.gnf") in parents
    assert len({r.call for r in _records()}) == 1


NARROW = ModelConfig(hidden=(16, 16, 32, 32, 32, 32, 64, 32, 16), patch_size=32, patch_k=8)
NARROW_PATCH = PatchConfig(num_nodes=32, patch_k=8)


def _normals(points):
    return predict_cloud_normals(init_patch2normal(NARROW, seed=1), points,
                                 patch_cfg=NARROW_PATCH, batch_size=128, device="cpu")


def _noisy_sphere(n, seed):
    pts, _ = sphere_cloud(n, seed=seed)
    noise = np.random.default_rng(seed + 1).normal(scale=0.02, size=pts.shape)
    return torch.as_tensor((pts + noise).astype(np.float32))


def test_learned_normals_record_their_stages():
    pts = _noisy_sphere(300, 4)
    _unrecorded()
    with _recording():
        _normals(pts)
    children = ("estimate", "orient", "select", "frames", "pair_knn", "model", "unrotate")
    assert _counts() == {"ngpd.normals": 1, **{f"ngpd.normals.{c}": 1 for c in children}}
    assert {r.parent for r in _records() if r.name != "ngpd.normals"} == {"ngpd.normals"}


def _sweeps_by_hand(idx: np.ndarray, seed: int, cap: int) -> int:
    """The orientation's sweeps: one a wave of newly visited points (a
    point joins once one of its neighbours is visited), and the sweep that
    finds no new point; at most ``cap``."""
    visited = np.zeros(len(idx), bool)
    visited[seed] = True
    sweeps = 0
    while sweeps < cap:
        sweeps += 1
        front = ~visited & visited[idx].any(axis=1)
        if not front.any():
            break
        visited |= front
    return sweeps


@pytest.mark.parametrize("cap", [0, 3])
def test_the_sweep_counter_counts_the_orientation_s_sweeps(cap):
    pts = _noisy_sphere(400, 8)
    nbh, _ = knn(pts, 6, exclude_self=True)
    normals = tnormals.pvt_normals(pts, nbh)
    before = tnormals.SWEEPS["orient"]
    tnormals.orient_normals(pts, normals, nbh, max_sweeps=cap)
    limit = cap if cap > 0 else 4 * int(np.ceil(np.sqrt(len(pts)))) + 16
    want = _sweeps_by_hand(nbh.idx.numpy(), int(torch.argmax(pts[:, 2])), limit)
    assert tnormals.SWEEPS["orient"] - before == want
    assert want == 3 if cap == 3 else want > 3


def test_learned_normals_are_bit_equal_without_spans(monkeypatch):
    pts = _noisy_sphere(300, 12)
    _unrecorded()
    plain = _normals(pts)
    with _recording():
        recorded = _normals(pts)
    monkeypatch.setattr(prof, "span", lambda name, device=None: contextlib.nullcontext())
    without = _normals(pts)
    assert torch.equal(plain, without) and torch.equal(recorded, without)


def test_an_unrecorded_span_costs_under_a_microsecond():
    # This thread's CPU time, so that a worker descheduled by its
    # neighbours in a parallel run is not charged for their time.
    n = 20_000
    best = float("inf")
    for _ in range(7):
        t0 = time.thread_time()
        for _ in range(n):
            with prof.span("ngpd.test.off"):
                pass
        best = min(best, (time.thread_time() - t0) / n)
    assert best < 1e-6, f"{best * 1e9:.0f} ns a span"
