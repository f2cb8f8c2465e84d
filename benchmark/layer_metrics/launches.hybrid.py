"""launches.hybrid: device kernels a cloud, from the trace."""


def read(rec):
    t = rec["trace"]
    return None if t is None else t["kernels"] / t["jobs"]
