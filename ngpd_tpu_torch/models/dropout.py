"""Dropout with explicit draws, split as ``core/noise.py`` splits noise.

Flax's ``nn.Dropout`` draws its keep mask from the ``dropout`` stream of
``jax.random``; torch's generators cannot give the same numbers, so the
port draws the masks in a step of their own (``draw_keep_masks``, from an
explicit ``torch.Generator``) and applies them in the pure forward
(``apply_dropout``), which the tests feed with the reference's own masks.
The formula is Flax's: ``where(keep, h / keep_prob, 0)`` with ``keep``
Bernoulli(keep_prob), keep_prob = 1 - rate.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def draw_keep_masks(shapes: Sequence[tuple], rate: float,
                    generator: torch.Generator) -> list[torch.Tensor]:
    """One boolean keep mask per shape, True with probability 1 - rate, on
    the generator's device."""
    return [torch.rand(tuple(s), generator=generator, device=generator.device) < 1.0 - rate
            for s in shapes]


def apply_dropout(h: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    if rate == 1.0:
        return torch.zeros_like(h)
    return torch.where(keep, h / (1.0 - rate), 0.0)


def dropout_sites(training: bool, rate: float, keep: Optional[Sequence[torch.Tensor]],
                  count: int) -> list:
    """The masks a forward applies at its ``count`` dropout sites: None
    each (no dropout) in eval mode or at rate 0; in train mode the given
    masks, which must be there."""
    if not training or rate == 0.0:
        return [None] * count
    if keep is None or len(keep) != count:
        raise ValueError(
            f"train mode with dropout rate {rate} needs {count} keep masks "
            "(draw them with the model's draw_keep_masks)")
    return list(keep)
