"""launches.p2ntrain: device kernels a Patch2Normal training job, from the
trace."""


def read(rec):
    t = rec["trace"]
    return None if t is None else t["kernels"] / t["jobs"]
