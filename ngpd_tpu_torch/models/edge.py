"""The edge-feature block that the DGCNN and EdgeConv share.

``edge_block(x, idx, order)``: x (B, P, C), idx (B, P, K) intra-patch
indices -> (B, P, K, 2C), ``[x_j - x_i, x_i]`` for the DGCNN
(``order="dgcnn"``, ``ngpd_tpu/models/dgcnn.py::_edge_features``) or
``[x_i, x_j - x_i]`` for EdgeConv (``order="edgeconv"``,
``ngpd_tpu/models/edgeconv.py``). On CUDA tensors the forward is one
launch of ``kernels/csrc/edge_block.cu``; on CPU tensors it is the plain
version, ``edge_block_plain`` (a gather, a subtraction and a ``cat``). The
two are equal bit for bit: one subtraction an element.

The backward is plain torch, the same on both devices: the gradient of
the plain expression, written out with autograd's own operations, so its
bits are autograd's. The difference half's gradient is added into x_j
over idx (``index_put_`` with ``accumulate``, the gather's backward); to
it is added, at each node, the x_i half's gradient less the difference
half's, summed over the neighbours. The reference has no kernel for it.
"""

from __future__ import annotations

import torch

from ..kernels import graph


def edge_block_plain(x: torch.Tensor, idx: torch.Tensor, order: str) -> torch.Tensor:
    """The plain version: (B, P, C), (B, P, K) -> (B, P, K, 2C)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    xj = x[b, idx]
    xi = x[:, :, None, :].expand_as(xj)
    parts = [xj - xi, xi] if order == "dgcnn" else [xi, xj - xi]
    return torch.cat(parts, dim=-1)


class _EdgeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, order):
        ctx.save_for_backward(idx)
        ctx.order, ctx.x_shape = order, x.shape
        if graph.check_edge_block(x, idx, order):
            return graph.edge_block(x, idx, order)
        return edge_block_plain(x, idx, order)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        b, p, c = ctx.x_shape
        first, second = g[..., :c], g[..., c:]
        g_diff, g_xi = (first, second) if ctx.order == "dgcnn" else (second, first)
        rows = torch.arange(b, device=idx.device)[:, None, None]
        g_xj = g.new_zeros((b, p, c)).index_put_((rows, idx), g_diff, accumulate=True)
        return g_xj + (g_xi - g_diff).sum(dim=2), None, None


def edge_block(x: torch.Tensor, idx: torch.Tensor, order: str) -> torch.Tensor:
    """The edge features of ``order`` ("dgcnn" or "edgeconv"), with the
    gradient of the plain expression to x."""
    return _EdgeBlock.apply(x.contiguous(), idx.to(torch.int64).contiguous(), order)
