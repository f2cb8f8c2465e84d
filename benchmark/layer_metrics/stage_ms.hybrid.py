"""stage_ms.hybrid: device milliseconds a cloud of every kernel of the
hybrid engine that is not a window kernel (K0, K1, K2): the per-point torch
stages, the Morton sort and the unsort."""


def read(rec):
    t = rec["trace"]
    if t is None:
        return None
    other = sum(v for g, v in t["groups"].items() if g not in ("k0", "k1", "k2"))
    return 1e3 * other / t["jobs"]
