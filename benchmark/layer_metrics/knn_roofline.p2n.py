"""knn_roofline.p2n: the least time of a cloud's three kNN searches (the
12 nearest other points, the 16 and the 64 nearest: the points read once,
each point's k distances and indices written once) over the kNN kernels'
device time, the searches and any merges."""

from benchmark import readers


def read(rec):
    return readers.knn_roofline(rec)
