"""Process groups and device meshes (torch), as ``ngpd_tpu/parallel/mesh.py``.

The reference runs its mesh from one controller: one process sees every
device and ``shard_map`` splits a global array. ``torch.distributed`` runs
one process a rank, each holding its own rows. So every function of
``parallel/`` takes this rank's rows and the mesh, and returns this rank's
rows; a collective names the process group of a mesh axis
(``mesh_axis``). The default process group is the caller's: ``init_group``
starts one over a ``FileStore``, NCCL for the card and gloo only where the
caller asks for the CPU.

Every collective goes through ``ngpd_tpu_torch/collectives.py``, which
counts the calls by kind in ``COLLECTIVES``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

POINTS_AXIS = "points"
DATA_AXIS = "dp"
MODEL_AXIS = "mp"

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_group(store_path: str, rank: int, world_size: int, device=None) -> torch.device:
    """Start the default process group of ``world_size`` ranks over a
    ``FileStore`` at ``store_path`` (one file that every rank can reach):
    NCCL on the card (this rank's card is ``rank`` modulo the card count),
    gloo on the CPU. Returns the rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(_BACKENDS[dev.type], store=store, rank=rank, world_size=world_size)
    return dev


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = (POINTS_AXIS,),
              device=None) -> DeviceMesh:
    """A dense mesh over the ranks of the default process group, on
    ``device`` (the card by default). ``n_devices`` must be the group's
    size: in ``torch.distributed`` every rank of the group is a member, so
    a mesh of n devices runs n ranks.

    The 2-D shape keeps the reference's rule as written: ``first`` is the
    largest divisor d of n with d <= n, which is n, so the mesh is (n, 1)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_group first")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} ranks; "
                         f"the process group has {n}")
    if dist.get_backend() != _BACKENDS[dev.type]:
        raise ValueError(f"a {dev.type} mesh needs the {_BACKENDS[dev.type]} backend, "
                         f"the process group runs {dist.get_backend()}")
    if len(axis_names) == 1:
        shape = (n,)
    elif len(axis_names) == 2:
        first = max(d for d in range(1, n + 1) if n % d == 0 and d <= n)
        shape = (first, n // first)
    else:
        raise ValueError("only 1-D or 2-D meshes supported here")
    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axis_names))


def mesh_axis(mesh: DeviceMesh, axis: str, device=None):
    """(process group, size, this rank's index) of one mesh axis; raises
    unless ``device`` (the card by default) is the mesh's device type."""
    dev = resolve_device(device)
    if dev.type != mesh.device_type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the call on {dev.type}")
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def shard_points(points, mesh: DeviceMesh, axis: str = POINTS_AXIS, pad_value: float = 1e30,
                 device=None):
    """Pad the leading axis of the whole array ``points`` to a multiple of
    the axis size and return (this rank's rows, num_valid) on the mesh's
    device.

    Padding rows sit at ``pad_value`` (a far sentinel): their squared
    distances overflow to +inf in float32, so kNN masks them out with no
    extra bookkeeping."""
    _, d, rank = mesh_axis(mesh, axis, device)
    x = torch.as_tensor(points)
    n = x.shape[0]
    rows = -(-n // d)
    if rows * d != n:
        pad = torch.full((rows * d - n,) + tuple(x.shape[1:]), pad_value, dtype=x.dtype)
        x = torch.cat([x, pad])
    return x[rank * rows : (rank + 1) * rows].to(mesh.device_type), n
