"""idle_share.p2ntrain: the share of the traced slice's wall time in which
no operation ran on the device."""

from benchmark import readers


def read(rec):
    return readers.idle_percent(rec)
