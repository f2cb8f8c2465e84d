"""pair_knn_ms.p2n: stream milliseconds a cloud of the intra-patch 12-NN,
the span ``ngpd.normals.pair_knn`` (one a cloud; the card's time between
its two events, idle inside included), in the traced slice."""

from benchmark import spans


def read(rec):
    return spans.stage_per_job(rec, "stream_ms", ("ngpd.normals.pair_knn",), 1)
