"""p2n_train_mfu: Patch2Normal's training steps' least operations (the
folded forward and its two backward products, ``counts/p2n_train.py``) of
every job of the window over the window's time, as a share of the chip's
float32 peak."""

from benchmark import readers


def read(rec):
    return readers.mfu_percent(rec)
