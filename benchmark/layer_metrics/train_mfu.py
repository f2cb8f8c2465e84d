"""train_mfu: the training steps' least operations (the folded forward and
its two backward products, ``counts/gcn_train.py``) of every job of the
window over the window's time, as a share of the chip's float32 peak."""

from benchmark import readers


def read(rec):
    return readers.mfu_percent(rec)
