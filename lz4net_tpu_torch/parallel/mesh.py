"""The 1-D mesh of ranks for data-parallel block codec work.

Port of ``lz4net_tpu/parallel/mesh.py``.  The codec's unit of
parallelism is the independent compressed block, so the one mesh axis
is pure data parallelism over blocks; a preset dictionary is replicated
by a broadcast from rank 0.  Plain tensors and explicit collectives
carry the layouts that ``NamedSharding`` carries there: ``block_sharding``
cuts a rank's contiguous rows out of the global batch (``P(BLOCK_AXIS)``)
and ``replicated`` broadcasts a tensor from rank 0 (``P()``).

By design a rank here is a process and owns one device, where a JAX mesh
spans every local device of a process: ``make_mesh``'s ``n_devices``
must be the world size.
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops.host_rows import resolve_device
from .distributed import backend_for, initialize

BLOCK_AXIS = "blocks"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(n_devices: int | None = None, device=None) -> DeviceMesh:
    """A 1-D mesh named ``blocks`` over every rank of the process group.

    With no group yet, it starts a world of one on a local TCP store, so
    every collective runs through a real group: NCCL on the card (the
    default ``device``), gloo for ``device="cpu"``.  A group the caller
    made is used as it is; its backend must be ``device``'s, or this
    raises ``ValueError``.  ``n_devices`` must be ``None`` or the world
    size.
    """
    device = resolve_device("cuda" if device is None else device)
    if not dist.is_initialized():
        initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=device)
    if dist.get_backend() != backend_for(device):
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"a mesh on {device.type} needs "
                         f"{backend_for(device)}")
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"n_devices={n_devices}: a rank is a process with "
                         f"one device, so the mesh spans the world of "
                         f"{world}")
    return init_device_mesh(device.type, (world,),
                            mesh_dim_names=(BLOCK_AXIS,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: the current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def block_sharding(mesh: DeviceMesh):
    """``put(x)``: this rank's rows ``[r * B / W, (r + 1) * B / W)`` of a
    global batch ``x`` (array or tensor, B rows over W ranks) as a tensor
    on its device."""
    rank, world = mesh.get_local_rank(), mesh.size()
    device = mesh_device(mesh)

    def put(x):
        x = torch.as_tensor(x)
        if x.shape[0] % world:
            raise ValueError(f"{x.shape[0]} rows do not divide over "
                             f"{world} ranks; pad the batch")
        n = x.shape[0] // world
        return x[rank * n:(rank + 1) * n].to(device)
    return put


def replicated(mesh: DeviceMesh):
    """``put(x)``: rank 0's ``x`` on every rank's device, by one broadcast
    (every rank passes a tensor of the same shape and type)."""
    group = mesh.get_group()
    device = mesh_device(mesh)

    def put(x):
        x = torch.as_tensor(x).to(device, copy=True).contiguous()
        dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
        return x
    return put
