"""normals_mfu: Patch2Normal's least operations (folded EdgeConvs, the
prepool, post-pool and head maps; ``benchmark/counts/p2n.py``) of every
cloud of the window over the window's time, as a share of the chip's
float32 peak."""

from benchmark import readers


def read(rec):
    return readers.mfu_percent(rec)
