"""denoise_rate: point-iterations of every whole job of the window over
the window's time to the end of its last job."""

from benchmark import readers


def read(rec):
    return readers.rate(rec)
