"""mesh_rate: faces of every whole mesh of the window, through every pass,
over the window's time to the end of its last mesh."""

from benchmark import readers


def read(rec):
    return readers.rate(rec)
