"""Multi-process wiring: ``torch.distributed`` in place of
``jax.distributed`` (``lz4net_tpu/parallel/distributed.py``).

One process per card.  After ``initialize`` every rank builds the same
mesh (``parallel.mesh``) and runs the same pipeline code
(``parallel.pipeline``): blocks sharded over the ranks, byte counts
all-reduced, outputs gathered in block order.  The backend follows the
device, NCCL for a CUDA device and gloo for the CPU; nothing moves a
CUDA device to gloo.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..ops.host_rows import resolve_device

TIMEOUT_S = 60.0


def backend_for(device: torch.device) -> str:
    """The process group's backend for ranks on ``device``."""
    return "nccl" if device.type == "cuda" else "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None,
               timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group (idempotent: returns at once if this process
    is in one).

    The arguments default to torchrun's variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` for the coordinator's ``host:port``, ``WORLD_SIZE``
    and ``RANK``.  With none of the three given anywhere there is no group
    to join, and it returns (``mesh.make_mesh`` then starts a world of
    one).  ``device`` defaults to the card ``cuda:{LOCAL_RANK}``, which is
    made the current device before NCCL starts; ``device="cpu"`` joins
    over gloo.  Every collective fails after ``timeout_s`` seconds, so a
    lost peer fails the call instead of hanging it.
    """
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and {"MASTER_ADDR",
                                        "MASTER_PORT"} <= env.keys():
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        return
    if any(v is None for v in given):
        raise ValueError("initialize needs the coordinator's address, the "
                         "number of processes and this process's id "
                         f"(got {given})")
    device = resolve_device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend_for(device), init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))


def is_multihost() -> bool:
    """True when this process is one of several ranks."""
    return dist.is_initialized() and dist.get_world_size() > 1
