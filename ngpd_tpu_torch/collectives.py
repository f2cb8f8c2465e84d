"""Counted collectives of the port's ``torch.distributed`` layer.

Every collective that ``parallel/``, ``core/``, ``learn/``, ``models/`` and
``meshproc/`` issue goes through these functions, and each adds one to
``COLLECTIVES`` by kind where it calls ``torch.distributed``, as
``kernels/window.py::LAUNCHES`` counts kernel launches. The reference's
check that the halo program holds no all-gather (its optimised HLO) reads
``COLLECTIVES["all_gather"]`` here. The module lives outside ``parallel/``
so that ``core/`` can import it without importing the sharded engines,
which import ``core/``.

The functions take a ``ProcessGroup`` (a ``DeviceMesh`` axis's, from
``parallel.mesh.mesh_axis``). Reductions return a new tensor and leave
their input alone. ``sum_across`` is the one differentiable reduction: its
backward sums the incoming gradients over the group, so that summing the
parameter gradients over the ranks afterwards gives the gradient of the
sum of every rank's loss (the batch statistics of a BatchNorm over the
global batch).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

COLLECTIVES = {"all_gather": 0, "all_reduce": 0, "broadcast": 0, "send": 0, "recv": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def reset_counts() -> None:
    for kind in COLLECTIVES:
        COLLECTIVES[kind] = 0


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The group's rows of ``x`` concatenated in rank order along axis 0
    (``jax.lax.all_gather(..., tiled=True)``); every rank passes the same
    shape."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] * dist.get_world_size(group),) + tuple(x.shape[1:]))
    # torch 2.13 renamed all_gather_into_tensor; older installs lack the new name.
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    COLLECTIVES["all_gather"] += 1
    gather(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``op`` ("sum", "max" or "min") of ``x`` over the group, in a new
    tensor (``psum``, ``pmax``, ``pmin``)."""
    out = x.clone(memory_format=torch.contiguous_format)
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, "sum", ctx.group), None


def sum_across(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the group (see the module's
    docstring for its backward)."""
    return _SumAcross.apply(x, group)


def broadcast_(tensors: Sequence[torch.Tensor], group, src: int = 0) -> None:
    """Overwrite ``tensors`` on every rank with the group rank ``src``'s."""
    root = dist.get_global_rank(group, src)
    for t in tensors:
        COLLECTIVES["broadcast"] += 1
        dist.broadcast(t, src=root, group=group)


def exchange(sends: Sequence[tuple[torch.Tensor, int]],
             recvs: Sequence[tuple[torch.Tensor, int]], group) -> None:
    """Paired point-to-point transfers, posted together so that two ranks
    sending to each other cannot deadlock: each ``(tensor, peer)`` of
    ``sends`` goes to group rank ``peer``, each buffer of ``recvs`` is
    filled from its peer. The i-th send to a peer pairs with that peer's
    i-th receive from this rank (i is the message's tag)."""
    ops = []
    for kind, op, items in (("send", dist.isend, sends), ("recv", dist.irecv, recvs)):
        tags: dict[int, int] = {}
        for t, peer in items:
            tag = tags[peer] = tags.get(peer, -1) + 1
            ops.append(dist.P2POp(op, t, dist.get_global_rank(group, peer), group, tag))
            COLLECTIVES[kind] += 1
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
