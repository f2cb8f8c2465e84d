"""Serialized model export (torch), the counterpart of
``ngpd_tpu/learn/export.py``'s StableHLO blob.

The L2-normalised predict step of a trained model is captured with
``torch.export`` at the example batch's shapes and serialised, with its
weights inside, to bytes (``torch.export.save``): a later process loads
and runs it without the model's class or a weights file
(``load_exported``), as the reference's TorchScript export was consumed
by its C++ application. A Patch2Normal takes the four patch arrays
(``x``, ``nbr_idx``, ``nbr_mask``, ``node_mask``); a DGCNN its ``x``.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Union

import torch
from torch import nn

PATCH_KEYS = ("x", "nbr_idx", "nbr_mask", "node_mask")


class _Predict(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *inputs):
        out = self.model(*inputs)
        return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)


def export_predict(model, example_batch: dict) -> bytes:
    """The predict step of ``model`` (a module, or a ``TrainState``) in
    eval mode, frozen at ``example_batch``'s shapes and dtypes."""
    model = getattr(model, "model", model)
    keys = PATCH_KEYS if "nbr_idx" in example_batch else ("x",)
    args = tuple(example_batch[k] for k in keys)
    was_training = model.training
    model.eval()
    try:
        exported = torch.export.export(_Predict(model), args)
    finally:
        model.train(was_training)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def save_exported(path: Union[str, Path], blob: bytes) -> None:
    Path(path).write_bytes(blob)


def load_exported(source: Union[str, Path, bytes]):
    """The exported predict step as a callable, from the bytes or a path."""
    blob = source if isinstance(source, (bytes, bytearray)) else Path(source).read_bytes()
    module = torch.export.load(io.BytesIO(blob)).module()

    def predict(*inputs):
        with torch.no_grad():
            return module(*inputs)

    return predict
