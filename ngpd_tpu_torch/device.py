"""Device selection shared by the port's entry points.

Every entry point takes ``device=None``, and ``None`` means ``"cuda"``.
Without a card, only an explicit ``device="cpu"`` runs: the port never
falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ngpd_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def exact_float32() -> None:
    """No TF32 on the port's paths: the reference runs every
    distance-like product at full float32 precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
