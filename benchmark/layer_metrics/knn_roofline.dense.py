"""knn_roofline.dense: the least time of a cloud's kNN searches (its
points read once, each point's k distances and indices written once) over
the kNN kernels' device time, the searches and their merges."""

from benchmark import readers


def read(rec):
    return readers.knn_roofline(rec)
