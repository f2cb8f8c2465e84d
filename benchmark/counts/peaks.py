"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): float32 outside the tensor cores, since the
program runs every product at float32 with TF32 off, and the HBM3
bandwidth."""

FLOPS = 67e12  # float32 operations per second, an FMA counted as two
BYTES = 3.35e12  # bytes per second


def least_seconds(flop: float, nbytes: float) -> float:
    """The least time the chip could take for this work: the larger of
    its operations over the peak rate and its bytes over the bandwidth."""
    return max(flop / FLOPS, nbytes / BYTES)
