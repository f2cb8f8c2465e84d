"""Patch2Normal, the patch -> centre-normal regressor (torch), as
``ngpd_tpu/models/patch2normal.py``:

  * ``num_edgeconv`` static EdgeConvs, hidden (64, 64, 128, 256, 256, 256);
  * optional DynamicEdgeConvs (``num_dynamic_edgeconv``, default 0);
  * all conv outputs concatenated -> ``num_prepool`` no-bias Linear +
    masked BN + LeakyReLU (1024 -> 512);
  * masked global max + mean pool;
  * postpool Linear + BN + Dropout blocks (1024 -> 256 -> 64), as many as
    ``hidden`` has entries left (the reference's loop, not
    ``num_postpool``);
  * head Linear -> 3.

Modules carry the Flax names (``layer{i}`` with ``lin`` and ``bn``,
``layer{i}_lin``, ``layer{i}_bn``, ``lastLayer``), so
``learn.weights.patch2normal_state_dict_from_variables`` maps a Flax tree
onto ``state_dict()`` key by key. Products run with ``torch.matmul`` on
channel-last blocks, as the Flax ``Dense`` layers do. ``train()`` /
``eval()`` switch BatchNorm between batch and running statistics and
dropout on and off. Dropout takes explicit keep masks (``models/dropout.py``):
``draw_keep_masks(batch, generator)`` draws them and the forward's ``keep``
applies them; a train-mode forward at a nonzero rate needs them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import ModelConfig
from .dropout import apply_dropout, draw_keep_masks, dropout_sites
from .edgeconv import DynamicEdgeConv, EdgeConv, MaskedBatchNorm, masked_global_pool

# Flax's lecun_normal: a normal truncated at two standard deviations, whose
# standard deviation is then 0.8796 of the untruncated one's.
_TRUNC_STD = 0.87962566103423978


def _dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    h = torch.matmul(x, lin.weight.T)
    return h if lin.bias is None else h + lin.bias


class Patch2NormalModel(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        num_convs = cfg.num_edgeconv + cfg.num_dynamic_edgeconv
        width = cfg.input_size
        for i in range(cfg.num_edgeconv):
            setattr(self, f"layer{i}", EdgeConv(width, cfg.hidden[i], cfg.leaky_slope))
            width = cfg.hidden[i]
        for j in range(cfg.num_dynamic_edgeconv):
            i = cfg.num_edgeconv + j
            setattr(self, f"layer{i}", DynamicEdgeConv(width, cfg.hidden[i],
                                                       cfg.dynamic_edgeconv_k,
                                                       cfg.leaky_slope))
            width = cfg.hidden[i]
        width = sum(cfg.hidden[:num_convs])
        for p in range(cfg.num_prepool):
            i = num_convs + p
            setattr(self, f"layer{i}_lin", nn.Linear(width, cfg.hidden[i], bias=False))
            setattr(self, f"layer{i}_bn", MaskedBatchNorm(cfg.hidden[i]))
            width = cfg.hidden[i]
        width *= 2  # max + mean pool
        self.num_postpool = len(cfg.hidden) - num_convs - cfg.num_prepool
        for q in range(self.num_postpool):
            i = num_convs + cfg.num_prepool + q
            setattr(self, f"layer{i}_lin", nn.Linear(width, cfg.hidden[i]))
            setattr(self, f"layer{i}_bn", MaskedBatchNorm(cfg.hidden[i]))
            width = cfg.hidden[i]
        self.lastLayer = nn.Linear(width, cfg.output_size)

    def dropout_shapes(self, batch: int) -> list[tuple]:
        """The shapes of the keep masks, one per postpool block."""
        first = self.cfg.num_edgeconv + self.cfg.num_dynamic_edgeconv + self.cfg.num_prepool
        return [(batch, self.cfg.hidden[first + q]) for q in range(self.num_postpool)]

    def draw_keep_masks(self, batch: int, generator: torch.Generator) -> list[torch.Tensor]:
        return draw_keep_masks(self.dropout_shapes(batch), self.cfg.dropout_rate, generator)

    def forward(self, x, nbr_idx, nbr_mask, node_mask, keep=None, group=None) -> torch.Tensor:
        """x (B, P, input_size), nbr_idx / nbr_mask (B, P, K), node_mask
        (B, P) -> raw outputs (B, output_size). ``keep``: the dropout keep
        masks of a train-mode forward (``draw_keep_masks``). ``group``: the
        data-parallel process group whose ranks hold the rest of the global
        batch; train-mode BatchNorm takes its statistics over all of it."""
        cfg = self.cfg
        num_convs = cfg.num_edgeconv + cfg.num_dynamic_edgeconv
        outs, h = [], x
        for i in range(cfg.num_edgeconv):
            h = getattr(self, f"layer{i}")(h, nbr_idx, nbr_mask, node_mask, group)
            outs.append(h)
        for i in range(cfg.num_edgeconv, num_convs):
            h = getattr(self, f"layer{i}")(h, node_mask, group)
            outs.append(h)
        h = torch.cat(outs, dim=-1)
        for i in range(num_convs, num_convs + cfg.num_prepool):
            h = _dense(h, getattr(self, f"layer{i}_lin"))
            h = getattr(self, f"layer{i}_bn")(h, node_mask, group)
            h = nn.functional.leaky_relu(h, cfg.leaky_slope)
        h = masked_global_pool(h, node_mask)
        rows = torch.ones(h.shape[:-1], dtype=torch.bool, device=h.device)
        masks = dropout_sites(self.training, cfg.dropout_rate, keep, self.num_postpool)
        for q in range(self.num_postpool):
            i = num_convs + cfg.num_prepool + q
            h = getattr(self, f"layer{i}_bn")(_dense(h, getattr(self, f"layer{i}_lin")), rows,
                                              group)
            if masks[q] is not None:
                h = apply_dropout(h, masks[q], cfg.dropout_rate)
        return _dense(h, self.lastLayer)

    def predict(self, x, nbr_idx, nbr_mask, node_mask) -> torch.Tensor:
        """L2-normalised prediction in eval mode (clamp 1e-12)."""
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                out = self(x, nbr_idx, nbr_mask, node_mask)
        finally:
            self.train(was_training)
        return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's lecun_normal in distribution: a truncated normal in
    [-2, 2], scaled to standard deviation sqrt(1 / fan_in). ``w`` is a
    torch weight (out, in, ...), so fan_in is its second axis."""
    lo = 0.5 * math.erfc(math.sqrt(2.0))  # the normal CDF at -2
    u = lo + torch.rand(w.shape, generator=generator, dtype=torch.float64) * (1.0 - 2.0 * lo)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)  # the inverse CDF
    std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        w.copy_((z * std).to(w.dtype))


def init_patch2normal(cfg: ModelConfig = ModelConfig(), seed: int = 0) -> Patch2NormalModel:
    """A Patch2Normal in eval mode with Flax's initialisers in distribution:
    lecun_normal weights, zero biases, BN scale 1 and bias 0, running mean
    0 and variance 1. The counterpart of ``init_model`` of
    ``ngpd_tpu/learn/train.py`` for the model alone; the draws come from a
    CPU ``torch.Generator`` seeded with ``seed``, so the numbers differ from
    ``jax.random.PRNGKey(seed)``'s."""
    return flax_init_(Patch2NormalModel(cfg), seed).eval()


def flax_init_(model: nn.Module, seed: int) -> nn.Module:
    """Flax's initialisers in distribution on every dense or 1x1-conv
    weight of ``model`` (lecun_normal, zero bias), drawn from a CPU
    ``torch.Generator`` seeded with ``seed``; BatchNorm layers keep scale
    1, bias 0, mean 0 and variance 1."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            _lecun_normal_(mod.weight, g)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
    return model
