"""The least-work counts against values worked out by hand."""

from __future__ import annotations

import pytest

from benchmark.counts import gcn, graph, knn, nvt, peaks


def test_the_dgcnn_is_counted_in_its_folded_form():
    p = 64
    convs = (4 * p * 17 * 64 + 4 * p * 64 * 64 + 4 * p * 64 * 128 + 4 * p * 128 * 256
             + 4 * p * 256 * 256 + 4 * p * 256 * 256)
    assert convs == 45_367_296
    emb = 2 * p * 1024 * 1024
    head = 2 * 2048 * 512 + 2 * 512 * 256 + 2 * 256 * 64 + 2 * 64 * 3
    assert gcn.dgcnn_flop_per_patch() == convs + emb + head == 181_977_472
    # The unfolded first maps, on every edge (K 3, then 8), count 2.9x more.
    unfolded = (2 * p * 3 * (34 * 64 + 128 * 64 + 128 * 128)
                + 2 * p * 8 * (256 * 256 + 512 * 256 + 512 * 256))
    assert unfolded + emb + head == 482_427_264


def test_a_mesh_job_counts_both_passes():
    cfg = {"passes": [{}, {}], "patch_nodes": 64, "emb_dims": 1024, "batch": 2048, "k": 8}
    w = gcn.job_work(cfg, {"subdiv": 6})
    assert w["flop"] == 2 * 81_920 * 181_977_472
    assert w["knn"] == [(81_920, 64)] * 2
    assert w["knn_bytes"] == 2 * (81_920 * 12 + 81_920 * 64 * 8)
    names = [x[0] for x in w["graph"]]
    assert names.count("feature_knn") == 240 and names.count("edge_block") == 480


def test_the_graph_kernels_count_their_bytes_once_and_the_pairs_once():
    flop, nbytes = graph.feature_knn(2048, 64, 256, 8)
    assert flop == 2048 * 2016 * 256 * 2
    assert nbytes == 2048 * 64 * 256 * 4 + 2048 * 64 * 8 * 4
    flop, nbytes = graph.edge_block(2048, 64, 256, 8)
    assert nbytes == 2048 * 64 * 256 * 4 + 2048 * 64 * 8 * 4 + 2048 * 64 * 8 * 512 * 4
    assert peaks.least_seconds(flop, nbytes) == pytest.approx(nbytes / 3.35e12)


def test_a_knn_search_is_counted_in_bytes():
    assert knn.search_bytes(32_768, 8) == 32_768 * 12 + 32_768 * 8 * 8


def test_the_denoise_counts_follow_the_route():
    cfg = {"feature_k": 32, "step_k": 8, "strategy": ["flat", "edge", "feature"],
           "hybrid": {"lagged_nvt1": True}}
    pair_nvt, pair_step = 20, 21 + 17 + 18
    assert nvt.NVT_PAIR == pair_nvt and nvt.step_pair(cfg["strategy"]) == pair_step
    h = nvt.job_work(cfg, {"points": 1000, "iterations": 20}, "hybrid")
    assert h["flop"] == 1000 * (20 * (32 * 20 + 8 * 56) + 32 * 20)
    k2 = [x for x in h["window"] if x[0] == "k2"][0]
    assert k2[1] == 20 and k2[3] == 4 * 1000 * (8 + 40)
    d = nvt.job_work(cfg, {"points": 1000, "iterations": 2}, "dense")
    assert d["flop"] == 1000 * 2 * (2 * 32 * 20 + 8 * 56)
    assert d["knn"] == [(1000, 6), (1000, 32), (1000, 8), (1000, 32), (1000, 8)]
