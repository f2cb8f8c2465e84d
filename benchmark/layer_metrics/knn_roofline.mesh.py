"""knn_roofline.mesh: the least time of a mesh's centroid kNN searches (the
centroids read once, each centroid's k distances and indices written once) over
the kNN kernels' device time, the searches and their merges."""

from benchmark import readers


def read(rec):
    return readers.knn_roofline(rec)
