"""``epilogue_ms.mesh`` on made-up traces: the epilogue kernel's device
milliseconds a mesh, where the program counted seven launches a DGCNN
batch; None without a trace or on another count."""

from __future__ import annotations

import pytest

from benchmark import catalog
from benchmark.counts import gcn


def mesh_rec(counters, jobs=2, by_name=None):
    # Two passes of 40 batches of 2,048 patches: 480 edge blocks a mesh.
    work = {"graph": gcn.graph_launches(81_920, 2_048, 64, 8) * 2}
    trace = {"counters": counters, "jobs": jobs, "groups": {}, "busy_s": 3.0, "window_s": 3.2,
             "kernels": 10_000,
             "by_name": by_name if by_name is not None else {
                 "void ngpd::dgcnn_epilogue_kernel<8, 4>(float const*, float const*)": 0.09,
                 "void ngpd::dgcnn_epilogue_kernel<3, 4>(float const*, float const*)": 0.05,
                 "void ngpd::dgcnn_epilogue_kernel<1, 4>(float const*, float const*)": 0.06,
                 "void ngpd::edge_block_kernel<true>(float const*, long long const*)": 0.37,
                 "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8": 3.1}}
    return {"work": work, "trace": trace}


def read(rec):
    return catalog.reader("layer_metrics", "epilogue_ms.mesh")(rec)


def test_the_reader_sums_the_epilogue_kernels_a_mesh():
    rec = mesh_rec({"dgcnn_epilogue": 2 * 560, "edge_block": 2 * 480})
    assert read(rec) == pytest.approx(1e3 * 0.20 / 2)


def test_the_reader_reads_none_without_a_trace():
    rec = mesh_rec({"dgcnn_epilogue": 2 * 560})
    rec["trace"] = None
    assert read(rec) is None


@pytest.mark.parametrize("counters", [{}, {"dgcnn_epilogue": 0}, {"dgcnn_epilogue": 2 * 480},
                                      {"dgcnn_epilogue": 560}],
                         ids=["uncounted", "none_launched", "six_a_batch", "one_mesh_of_two"])
def test_the_reader_reads_none_on_another_count(counters):
    """The parent's program has no such counter; a program that launched
    the epilogue other than seven times a batch is not read."""
    assert read(mesh_rec(counters)) is None


def test_the_reader_reads_none_without_the_graph_work():
    rec = mesh_rec({"dgcnn_epilogue": 2 * 560})
    rec["work"] = {}
    assert read(rec) is None


def test_the_epilogue_kernel_falls_in_no_group_that_another_metric_reads():
    """Its name holds no fragment of ``trace.GROUPS``: ``matmul_ms.mesh`` and
    ``graph_roofline.mesh`` read the kernels they read before."""
    from benchmark import trace

    for k in (1, 3, 8, 0):
        for w in (4, 1):
            name = (f"void ngpd::dgcnn_epilogue_kernel<{k}, {w}>(float const*, float const*, "
                    "float const*, float const*, float*, int, int, int)")
            assert trace.group(name) == "elementwise_other"
