"""Masked EdgeConv / DynamicEdgeConv over fixed-size patches (torch), as
``ngpd_tpu/models/edgeconv.py``.

A patch is a dense block: features (B, P, F), intra-patch neighbour
indices (B, P, K) with a validity mask. EdgeConv:
h_i = aggr_j MLP([x_i, x_j - x_i]) with MLP = Linear(2F -> F', no bias) +
masked BatchNorm + LeakyReLU(0.2); aggr = masked mean for the static convs,
masked max for the dynamic ones. The edge feature is built as the reference
builds it, a (B, P, K, 2F) block times the weight, so the products round
alike.

``MaskedBatchNorm`` is not ``nn.BatchNorm1d``: its statistics cover the
valid nodes only, its variance is the biased one, and its running update
is Flax's, ``momentum * old + (1 - momentum) * batch`` with momentum 0.9.
Parameters carry the Flax names' roles: ``weight`` is ``scale``,
``running_mean`` / ``running_var`` are ``batch_stats`` ``mean`` / ``var``.

A train-mode forward with a data-parallel ``group`` (a process group)
takes each rank's rows of the global batch and computes the statistics
over the global batch, as the reference's GSPMD program does over its
sharded batch: the masked sums and the count are summed over the group,
then the variance the same two-pass way. Per-rank statistics would be
torch DDP's default, and another model.
"""

from __future__ import annotations

import torch
from torch import nn

from ..collectives import sum_across
from ..core.patches import masked_pair_knn
from .edge import edge_block

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the last axis with statistics over valid rows only."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
        # x: (..., F); mask: (...,) boolean over the leading dims.
        if self.training:
            m = mask.to(x.dtype)[..., None]
            dims = tuple(range(x.dim() - 1))
            total, cnt = torch.sum(x * m, dim=dims), torch.sum(m)
            if group is not None:
                both = sum_across(torch.cat([total, cnt[None]]), group)
                total, cnt = both[:-1], both[-1]
            cnt = torch.clamp(cnt, min=1.0)
            mean = total / cnt
            sq = torch.sum((x - mean) ** 2 * m, dim=dims)
            var = (sq if group is None else sum_across(sq, group)) / cnt
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + BN_EPS)
        return y * self.weight + self.bias


def _edge_block(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """cat(x_i, x_j - x_i): (B, P, F), (B, P, K) -> (B, P, K, 2F)
    (``models/edge.py``: the edge-block kernel on CUDA tensors)."""
    return edge_block(x, idx, "edgeconv")


class EdgeConv(nn.Module):
    """Static-graph EdgeConv with masked mean aggregation."""

    def __init__(self, in_features: int, features: int, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.lin = nn.Linear(2 * in_features, features, bias=False)
        self.bn = MaskedBatchNorm(features)

    def forward(self, x, nbr_idx, nbr_mask, node_mask, group=None):
        h = torch.matmul(_edge_block(x, nbr_idx), self.lin.weight.T)  # (B, P, K, F')
        m = (nbr_mask & node_mask[:, :, None]).to(h.dtype)[..., None]
        agg = torch.sum(h * m, dim=2) / torch.clamp(torch.sum(m, dim=2), min=1.0)
        return nn.functional.leaky_relu(self.bn(agg, node_mask, group), self.negative_slope)


class DynamicEdgeConv(nn.Module):
    """EdgeConv over a feature-space kNN graph rebuilt per layer, masked
    max aggregation, k static."""

    def __init__(self, in_features: int, features: int, k: int = 8,
                 negative_slope: float = 0.2):
        super().__init__()
        self.k = k
        self.negative_slope = negative_slope
        self.lin = nn.Linear(2 * in_features, features, bias=False)
        self.bn = MaskedBatchNorm(features)

    def forward(self, x, node_mask, group=None):
        # The distances feed only the selection: no graph is kept for them.
        with torch.no_grad():
            idx, nbr_mask = masked_pair_knn(x, node_mask, self.k)
        h = torch.matmul(_edge_block(x, idx), self.lin.weight.T)
        m = (nbr_mask & node_mask[:, :, None])[..., None]
        agg = torch.amax(torch.where(m, h, -torch.inf), dim=2)
        agg = torch.where(torch.isfinite(agg), agg, 0.0)
        return nn.functional.leaky_relu(self.bn(agg, node_mask, group), self.negative_slope)


def masked_global_pool(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Concat of the masked global max pool and mean pool."""
    m = node_mask[..., None]
    mx = torch.amax(torch.where(m, x, -torch.inf), dim=1)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    s = torch.sum(torch.where(m, x, 0.0), dim=1)
    cnt = torch.clamp(torch.sum(node_mask, dim=1, keepdim=True), min=1.0)
    return torch.cat([mx, s / cnt], dim=-1)
