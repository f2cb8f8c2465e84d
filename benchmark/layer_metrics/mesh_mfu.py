"""mesh_mfu: the DGCNN's least operations (folded edge convolutions) of
every mesh of the window over the window's time, as a share of the chip's
float32 peak."""

from benchmark import readers


def read(rec):
    return readers.mfu_percent(rec)
