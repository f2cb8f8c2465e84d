"""denoise_mfu: the least operations of every job of the window
(``benchmark/counts/nvt.py``) over the window's time, as a share of the
chip's float32 peak."""

from benchmark import readers


def read(rec):
    return readers.mfu_percent(rec)
