"""The legacy DGCNN, the GCN-Denoiser patch network (torch), as
``ngpd_tpu/models/dgcnn.py``, for inference.

  * input (B, 20, 64): 17 per-node features + 3 fixed neighbour indices;
  * three fixed-graph edge convs (64, 64, 128) over those 3 neighbours,
    edge feature (x_j - x_i, x_i), max-pooled over neighbours;
  * three dynamic feature-space kNN convs, k = 8, self-inclusive, channels
    (256, 256, 256);
  * concat (1024) -> 1x1 conv to emb_dims + BN + LeakyReLU;
  * max + mean pool concat -> MLP 2 emb_dims -> 512 -> 256 -> 64 -> 3.

Parameters carry the reference torch model's names (``conv{i}.0.weight``,
``bn{i}.*`` shared with ``conv{i}.1.*``, ``conv7.0.weight``, ``linear{1..4}``),
so a reference ``.t7`` state dict or TorchScript ``.pt`` loads with
``load_state_dict``. The forward runs channel-last with ``torch.matmul``,
as the Flax model's ``Dense`` layers do.

BatchNorm follows Flax's ``nn.BatchNorm(momentum=0.9)`` (eps 1e-5), not
torch's: in eval mode it reads the running statistics; in train mode it
normalises with the batch statistics over every axis but the last, the
variance computed Flax's fast way, ``max(mean(x^2) - mean(x)^2, 0)``, and
updates the running statistics as ``0.9 * old + 0.1 * batch`` with the
biased variance (torch's own would take two passes, keep the unbiased
variance and call the 0.1 its momentum). Dropout (after bn8 and bn9) takes
explicit keep masks (``models/dropout.py``). ``feature_knn`` runs without
autograd: its distances feed only the selection. With a data-parallel
``group`` a train-mode forward takes the batch statistics over the global
batch: the sums of h and h^2 and the count are summed over the group, then
the fast variance as above. Each edge conv's BatchNorm, LeakyReLU and max
over neighbours, and conv7's BatchNorm and LeakyReLU, are one
``dgcnn_epilogue``: on the card a kernel, in an eval-mode forward that takes
no gradient; otherwise ``dgcnn_epilogue_plain``, bit for bit the same.

``BetterDGCNN`` is the parameterised generalisation of
``ngpd_tpu/models/dgcnn.py``; its modules carry the Flax names
(``conv{i}.Dense_0``, ``conv{i}.BatchNorm_0``, ``emb``, ``emb_bn``,
``head{i}``, ``head{i}_bn``, ``out``), so its Flax tree maps onto
``state_dict()`` path by path, as Patch2Normal's does.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from ..collectives import sum_across
from ..kernels import graph
from ..ops.knn import _topk_smallest
from .dropout import apply_dropout, draw_keep_masks, dropout_sites
from .edge import edge_block

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # Flax's: running = 0.9 * running + 0.1 * batch
LEAKY_SLOPE = 0.2
EDGE_CHANNELS = (64, 64, 128, 256, 256, 256)
NUM_FIXED = 3  # fixed-graph convs; the rest take the feature kNN
# Bytes of one (chunk, P, P, C) difference block of feature_sqdist; at batch
# 2048, 64 nodes and 256 channels the whole batch would take 8.6 GB.
KNN_BLOCK_BYTES = 1 << 30


@torch.no_grad()
def feature_knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """Self-inclusive feature-space kNN: (B, P, C) -> (B, P, k) indices.

    The distance is the sum of squared differences, as the reference
    computes it; among equal distances the lower index comes first, as
    ``jax.lax.top_k`` keeps it (masked patch nodes carry equal features,
    so the ties are real). On CUDA tensors one launch of
    ``kernels/csrc/feature_knn.cu``; on CPU tensors ``feature_knn_plain``."""
    if not graph.check_feature_knn(x, k):
        return feature_knn_plain(x, k)
    return graph.feature_knn(x, k)


@torch.no_grad()
def feature_knn_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """``feature_knn``'s plain version on any device: ``feature_sqdist``,
    then the k smallest of each row on the int64 key of ``ops/knn.py``."""
    b, p, _ = x.shape
    d = feature_sqdist(x).reshape(-1, p)
    _, idx = _topk_smallest(d, torch.arange(p, device=x.device).expand(d.shape[0], p), k)
    return idx.reshape(b, p, k)


@torch.no_grad()
def feature_sqdist(x: torch.Tensor) -> torch.Tensor:
    """(B, P, C) -> (B, P, P) sums of squared feature differences, summed
    by ``torch.sum`` over difference blocks of at most KNN_BLOCK_BYTES."""
    b, p, c = x.shape
    chunk = max(1, KNN_BLOCK_BYTES // (p * p * c * x.element_size()))
    return torch.cat([torch.sum((xc[:, :, None, :] - xc[:, None, :, :]).square_(), dim=-1)
                      for xc in torch.split(x, chunk)])


def _edge_features(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """cat(x_j - x_i, x_i): (B, P, C), (B, P, K) -> (B, P, K, 2C)
    (``models/edge.py``: the edge-block kernel on CUDA tensors)."""
    return edge_block(x, idx, "dgcnn")


def batch_stats(h: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Flax's batch statistics over every axis but the last: the mean and
    the fast variance max(mean(h^2) - mean(h)^2, 0); with ``group`` over
    every rank's rows."""
    dims = tuple(range(h.dim() - 1))
    if group is None:
        mean = torch.mean(h, dim=dims)
        mean2 = torch.mean(h * h, dim=dims)
    else:
        c = h.shape[-1]
        count = h.new_full((1,), h.numel() // c)
        sums = sum_across(torch.cat([torch.sum(h, dim=dims), torch.sum(h * h, dim=dims), count]),
                          group)
        mean, mean2 = sums[:c] / sums[-1], sums[c : 2 * c] / sums[-1]
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


def _bn_terms(h: torch.Tensor, bn: nn.Module, training: bool = False,
              group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm's mean and multiplier over the last axis, Flax's order of
    operations; in train mode from the batch statistics, updating ``bn``'s
    running ones."""
    if training:
        mean, var = batch_stats(h, group)
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    return mean, torch.rsqrt(var + BN_EPS) * bn.weight


def _bn(h: torch.Tensor, bn: nn.Module, training: bool = False, group=None) -> torch.Tensor:
    """BatchNorm over the last axis (``_bn_terms``): (h - mean) * mul + bias."""
    mean, mul = _bn_terms(h, bn, training, group)
    return (h - mean) * mul + bn.bias


def _act(h: torch.Tensor) -> torch.Tensor:
    return nn.functional.leaky_relu(h, LEAKY_SLOPE)


def dgcnn_epilogue(h: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                   k: int) -> torch.Tensor:
    """LeakyReLU of ``((h - mean) * mul) + bias``, then for k > 1 the max
    over the k neighbours of axis -2: (..., k, C) -> (..., C). On CUDA
    tensors one launch of ``kernels/csrc/dgcnn_epilogue.cu``, which takes
    no gradient; on CPU tensors ``dgcnn_epilogue_plain``. The two are equal
    bit for bit."""
    if not graph.check_dgcnn_epilogue(h, mean, mul, bias, k):
        return dgcnn_epilogue_plain(h, mean, mul, bias, k)
    return graph.dgcnn_epilogue(h, mean, mul, bias, k)


def dgcnn_epilogue_plain(h: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                         bias: torch.Tensor, k: int) -> torch.Tensor:
    """``dgcnn_epilogue``'s plain version on any device, which autograd
    differentiates: ``_bn``'s expression, ``_act``, ``torch.amax``."""
    y = _act((h - mean) * mul + bias)
    return torch.amax(y, dim=-2) if k > 1 else y


def _bn_act(h: torch.Tensor, bn: nn.Module, training: bool, group, k: int) -> torch.Tensor:
    """``dgcnn_epilogue`` of ``h`` with ``bn``'s terms: the kernel's route
    in eval mode where no gradient is taken, else the plain version."""
    mean, mul = _bn_terms(h, bn, training, group)
    if training or (torch.is_grad_enabled()
                    and any(t.requires_grad for t in (h, mul, bn.bias))):
        return dgcnn_epilogue_plain(h, mean, mul, bn.bias, k)
    return dgcnn_epilogue(h, mean, mul, bn.bias, k)


class DGCNN(nn.Module):
    def __init__(self, k: int = 8, init_dims: int = 17, emb_dims: int = 1024,
                 output_channels: int = 3, dropout: float = 0.5):
        super().__init__()
        self.k = k
        self.init_dims = init_dims
        self.dropout = dropout
        dims = (init_dims,) + EDGE_CHANNELS
        for i, c in enumerate(EDGE_CHANNELS, start=1):
            bn = nn.BatchNorm2d(c, eps=BN_EPS)
            setattr(self, f"bn{i}", bn)
            setattr(self, f"conv{i}", nn.Sequential(
                nn.Conv2d(2 * dims[i - 1], c, 1, bias=False), bn, nn.LeakyReLU(LEAKY_SLOPE)))
        self.bn7 = nn.BatchNorm1d(emb_dims, eps=BN_EPS)
        self.conv7 = nn.Sequential(nn.Conv1d(sum(EDGE_CHANNELS), emb_dims, 1, bias=False),
                                   self.bn7, nn.LeakyReLU(LEAKY_SLOPE))
        self.linear1 = nn.Linear(2 * emb_dims, 512, bias=False)
        self.bn8 = nn.BatchNorm1d(512, eps=BN_EPS)
        self.linear2 = nn.Linear(512, 256)
        self.bn9 = nn.BatchNorm1d(256, eps=BN_EPS)
        self.linear3 = nn.Linear(256, 64)
        self.bn10 = nn.BatchNorm1d(64, eps=BN_EPS)
        self.linear4 = nn.Linear(64, output_channels)

    def dropout_shapes(self, batch: int) -> list[tuple]:
        return [(batch, self.linear1.out_features), (batch, self.linear2.out_features)]

    def draw_keep_masks(self, batch: int, generator: torch.Generator) -> list[torch.Tensor]:
        return draw_keep_masks(self.dropout_shapes(batch), self.dropout, generator)

    def forward(self, inputs: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None,
                group=None) -> torch.Tensor:
        """inputs: (B, 20, P) channel-first (17 features + 3 neighbour
        rows) -> (B, output_channels). ``keep``: the dropout keep masks of
        a train-mode forward (``draw_keep_masks``); ``group``: the
        data-parallel process group (see the module's docstring)."""
        train = self.training
        masks = dropout_sites(train, self.dropout, keep, 2)
        x = inputs[:, : self.init_dims, :].transpose(1, 2)  # (B, P, 17)
        idx = inputs[:, self.init_dims : self.init_dims + 3, :].to(torch.int64).transpose(1, 2)
        outs = []
        for i in range(1, len(EDGE_CHANNELS) + 1):
            conv, bn = getattr(self, f"conv{i}")[0], getattr(self, f"bn{i}")
            nbr = idx if i <= NUM_FIXED else feature_knn(x, self.k)
            h = _edge_features(x, nbr) @ conv.weight[:, :, 0, 0].T
            kk = h.shape[2]  # max over the neighbours; one leaves no axis to reduce
            x = _bn_act(h if kk > 1 else h.squeeze(2), bn, train, group, kk)
            outs.append(x)
        h = torch.cat(outs, dim=-1) @ self.conv7[0].weight[:, :, 0].T  # (B, P, E)
        h = _bn_act(h, self.bn7, train, group, 1)
        h = torch.cat([torch.amax(h, dim=1), torch.mean(h, dim=1)], dim=-1)
        h = _act(_bn(h @ self.linear1.weight.T, self.bn8, train, group))
        if masks[0] is not None:
            h = apply_dropout(h, masks[0], self.dropout)
        h = _act(_bn(self.linear2(h), self.bn9, train, group))
        if masks[1] is not None:
            h = apply_dropout(h, masks[1], self.dropout)
        h = _act(_bn(self.linear3(h), self.bn10, train, group))
        return self.linear4(h)


def dgcnn_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> DGCNN:
    """The DGCNN whose widths match a state dict (emb_dims from conv7, the
    output width from linear4), loaded strictly and in eval mode."""
    model = DGCNN(emb_dims=int(state_dict["conv7.0.weight"].shape[0]),
                  output_channels=int(state_dict["linear4.weight"].shape[0]))
    model.load_state_dict(state_dict, strict=True)
    return model.eval().requires_grad_(False)


class FlaxBatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm(momentum=0.9)`` over the last axis (see
    ``_bn``), with the roles of its variables: ``weight`` is ``scale``,
    ``running_mean`` / ``running_var`` are ``batch_stats`` ``mean`` / ``var``."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, h: torch.Tensor, group=None) -> torch.Tensor:
        return _bn(h, self, self.training, group)


class ConvBlock(nn.Module):
    """1x1 conv (a dense layer) + BatchNorm + LeakyReLU, max over neighbours."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features, bias=False)
        self.BatchNorm_0 = FlaxBatchNorm(features)

    def forward(self, e: torch.Tensor, group=None) -> torch.Tensor:
        return torch.amax(_act(self.BatchNorm_0(e @ self.Dense_0.weight.T, group)), dim=2)


class BetterDGCNN(nn.Module):
    """Configurable counts of fixed-graph edge convs, dynamic kNN convs and
    head linears: ``channels`` the per-conv widths (num_edge_convs +
    num_dynamic_convs of them), ``head_channels`` the post-pool MLP widths;
    dropout after the first two head layers."""

    def __init__(self, channels: Sequence[int] = EDGE_CHANNELS, num_edge_convs: int = 3,
                 num_dynamic_convs: int = 3, head_channels: Sequence[int] = (512, 256, 64),
                 k: int = 8, emb_dims: int = 1024, dropout: float = 0.5,
                 output_channels: int = 3, init_dims: int = 17):
        super().__init__()
        if len(channels) != num_edge_convs + num_dynamic_convs:
            raise ValueError(f"{len(channels)} channel widths for "
                             f"{num_edge_convs} + {num_dynamic_convs} convs")
        self.channels, self.head_channels = tuple(channels), tuple(head_channels)
        self.num_edge_convs, self.k, self.dropout = num_edge_convs, k, dropout
        self.init_dims = init_dims
        width = init_dims
        for i, c in enumerate(self.channels):
            setattr(self, f"conv{i}", ConvBlock(2 * width, c))
            width = c
        self.emb = nn.Linear(sum(self.channels), emb_dims, bias=False)
        self.emb_bn = FlaxBatchNorm(emb_dims)
        width = 2 * emb_dims
        for li, c in enumerate(self.head_channels):
            setattr(self, f"head{li}", nn.Linear(width, c, bias=li > 0))
            setattr(self, f"head{li}_bn", FlaxBatchNorm(c))
            width = c
        self.out = nn.Linear(width, output_channels)

    def dropout_shapes(self, batch: int) -> list[tuple]:
        return [(batch, c) for c in self.head_channels[:2]]

    def draw_keep_masks(self, batch: int, generator: torch.Generator) -> list[torch.Tensor]:
        return draw_keep_masks(self.dropout_shapes(batch), self.dropout, generator)

    def forward(self, inputs: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None,
                group=None) -> torch.Tensor:
        masks = dropout_sites(self.training, self.dropout, keep,
                              len(self.dropout_shapes(1)))
        x = inputs[:, : self.init_dims, :].transpose(1, 2)
        idx = inputs[:, self.init_dims : self.init_dims + 3, :].to(torch.int64).transpose(1, 2)
        outs, h = [], x
        for i in range(len(self.channels)):
            nbr = idx if i < self.num_edge_convs else feature_knn(h, self.k)
            h = getattr(self, f"conv{i}")(_edge_features(h, nbr), group)
            outs.append(h)
        h = _act(self.emb_bn(torch.cat(outs, dim=-1) @ self.emb.weight.T, group))
        h = torch.cat([torch.amax(h, dim=1), torch.mean(h, dim=1)], dim=-1)
        for li in range(len(self.head_channels)):
            lin = getattr(self, f"head{li}")
            h = h @ lin.weight.T if lin.bias is None else lin(h)
            h = _act(getattr(self, f"head{li}_bn")(h, group))
            if li < len(masks) and masks[li] is not None:
                h = apply_dropout(h, masks[li], self.dropout)
        return self.out(h)
