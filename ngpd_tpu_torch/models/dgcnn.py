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
as the Flax model's ``Dense`` layers do; BatchNorm uses the running
statistics with Flax's formula and eps 1e-5, dropout is off.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from ..ops.knn import _topk_smallest

BN_EPS = 1e-5
LEAKY_SLOPE = 0.2
EDGE_CHANNELS = (64, 64, 128, 256, 256, 256)
NUM_FIXED = 3  # fixed-graph convs; the rest take the feature kNN
# Bytes of one (chunk, P, P, C) difference block of feature_knn; at batch
# 2048, 64 nodes and 256 channels the whole batch would take 8.6 GB.
KNN_BLOCK_BYTES = 1 << 30


def feature_knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """Self-inclusive feature-space kNN: (B, P, C) -> (B, P, k) indices.

    The distance is the sum of squared differences, as the reference
    computes it; among equal distances the lower index comes first, as
    ``jax.lax.top_k`` keeps it (masked patch nodes carry equal features,
    so the ties are real)."""
    b, p, c = x.shape
    chunk = max(1, KNN_BLOCK_BYTES // (p * p * c * x.element_size()))
    cols = torch.arange(p, device=x.device).expand(p, p)
    out = []
    for xc in torch.split(x, chunk):
        diff = xc[:, :, None, :] - xc[:, None, :, :]
        d = torch.sum(diff.square_(), dim=-1)
        _, idx = _topk_smallest(d.reshape(-1, p), cols.repeat(xc.shape[0], 1), k)
        out.append(idx.reshape(xc.shape[0], p, k))
    return torch.cat(out)


def _edge_features(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """cat(x_j - x_i, x_i): (B, P, C), (B, P, K) -> (B, P, K, 2C)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    xj = x[b, idx]
    xi = x[:, :, None, :].expand_as(xj)
    return torch.cat([xj - xi, xi], dim=-1)


def _bn(h: torch.Tensor, bn: nn.Module) -> torch.Tensor:
    """Inference BatchNorm over the last axis, Flax's order of operations."""
    mul = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
    return (h - bn.running_mean) * mul + bn.bias


def _act(h: torch.Tensor) -> torch.Tensor:
    return nn.functional.leaky_relu(h, LEAKY_SLOPE)


class DGCNN(nn.Module):
    def __init__(self, k: int = 8, init_dims: int = 17, emb_dims: int = 1024,
                 output_channels: int = 3):
        super().__init__()
        self.k = k
        self.init_dims = init_dims
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

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs: (B, 20, P) channel-first (17 features + 3 neighbour
        rows) -> (B, output_channels)."""
        x = inputs[:, : self.init_dims, :].transpose(1, 2)  # (B, P, 17)
        idx = inputs[:, self.init_dims : self.init_dims + 3, :].to(torch.int64).transpose(1, 2)
        outs = []
        for i in range(1, len(EDGE_CHANNELS) + 1):
            conv, bn = getattr(self, f"conv{i}")[0], getattr(self, f"bn{i}")
            nbr = idx if i <= NUM_FIXED else feature_knn(x, self.k)
            h = _edge_features(x, nbr) @ conv.weight[:, :, 0, 0].T
            x = torch.amax(_act(_bn(h, bn)), dim=2)  # max over neighbours
            outs.append(x)
        h = torch.cat(outs, dim=-1) @ self.conv7[0].weight[:, :, 0].T  # (B, P, E)
        h = _act(_bn(h, self.bn7))
        h = torch.cat([torch.amax(h, dim=1), torch.mean(h, dim=1)], dim=-1)
        h = _act(_bn(h @ self.linear1.weight.T, self.bn8))
        h = _act(_bn(self.linear2(h), self.bn9))
        h = _act(_bn(self.linear3(h), self.bn10))
        return self.linear4(h)


def dgcnn_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> DGCNN:
    """The DGCNN whose widths match a state dict (emb_dims from conv7, the
    output width from linear4), loaded strictly and in eval mode."""
    model = DGCNN(emb_dims=int(state_dict["conv7.0.weight"].shape[0]),
                  output_channels=int(state_dict["linear4.weight"].shape[0]))
    model.load_state_dict(state_dict, strict=True)
    return model.eval().requires_grad_(False)
