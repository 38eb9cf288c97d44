"""Multi-process initialization: one process per device.

Counterpart of rso/ba/multihost.py.  On several cards or hosts each process
runs the same program (SPMD); torch.distributed wires the process group,
and the mesh of rso_torch.ba.distributed covers every rank, so NCCL carries
the landmark sums between cards.  Nothing else in the package changes per
process.  NCCL takes one rank per card; several ranks share one card only
through gloo.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from rso_torch.mesh import default_backend, make_device_mesh


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None) -> bool:
    """Start the process group from the arguments, else from torchrun's
    environment (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK
    picks the card).  No-op, returning False, for a single process.

    coordinator_address: "host:port" (TCP) or an init_method URL such as
    "file:///path/to/store".  backend: NCCL where CUDA is available unless
    the caller names another (e.g. "gloo" for several ranks on one card),
    gloo on the CPU.  Each rank takes card LOCAL_RANK (else its rank)
    modulo the card count as its current device.
    """
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return False
    num_processes = int(num_processes if num_processes is not None
                        else os.environ.get("WORLD_SIZE", "1"))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("RANK", "0"))
    if num_processes <= 1:
        return False
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    cuda = torch.cuda.is_available()
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend or default_backend("cuda" if cuda else "cpu"),
        init_method=coordinator_address, world_size=num_processes,
        rank=process_id)
    return True


def global_landmark_mesh(axis: str = "lmk") -> DeviceMesh:
    """Mesh over every rank of the world for the distributed BA."""
    return make_device_mesh((dist.get_world_size(),), (axis,))
