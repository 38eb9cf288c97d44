"""Device meshes over torch.distributed, and the sums the mesh forms need.

The reference lays its devices out as a jax Mesh with named axes ('lmk';
'win','lmk'; 'seq') and sums with lax.psum inside shard_map.  The port runs
one process per device (SPMD: torchrun, or torch.multiprocessing) with a
torch.distributed.device_mesh.DeviceMesh carrying the same axis names, and
sums with torch.distributed.all_reduce over one axis's process group: NCCL
between cards, gloo on the CPU (gloo also takes CUDA tensors, staging them
through the host, so several ranks can share one card).  NCCL takes one
rank per card.

A process with no process group gets a one-rank group (through a
HashStore, so no port is opened), as the reference's make_mesh works on one
device: its all_reduce is a copy.

On an NCCL group the all_reduces of an LM solve are captured in its CUDA
graph (rso_torch.ba.ba.solve_lm), as rso's psums are compiled into its
shard_map'd while loop.  gloo's collectives run on the host and cannot be
captured: on a gloo group the solve runs eagerly, by that rule
(`AllReduce.capturable`).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from rso_torch.engine import _device
from rso_torch.kernels._lib import COLLECTIVES, count_collective

__all__ = ["COLLECTIVES", "AllReduce", "check_mesh", "default_backend",
           "ensure_group", "gather_slices", "make_device_mesh"]


def default_backend(device) -> str:
    """NCCL for CUDA tensors, gloo for CPU tensors."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def ensure_group(device="cuda") -> None:
    """Start a one-rank process group where none exists, on `device`'s
    backend (NCCL on the GPU unless the caller passes device="cpu"; raises
    without CUDA).  An existing group is used as it is: its backend is the
    one whoever started it named."""
    if not dist.is_initialized():
        dist.init_process_group(default_backend(_device(device)),
                                store=dist.HashStore(), rank=0, world_size=1)


def make_device_mesh(shape: tuple, names: tuple, device="cuda",
                     ranks=None) -> DeviceMesh:
    """A DeviceMesh of `ranks` (the first prod(shape) ranks of the world by
    default), laid out row-major in `shape` with axis `names`.  Every rank
    of the world calls it (creating the axes' groups is collective)."""
    ensure_group(device)
    n, world = math.prod(shape), dist.get_world_size()
    ranks = list(range(world) if ranks is None else ranks)
    if n < 1 or n > len(ranks) or max(ranks[:n]) >= world:
        raise ValueError(f"a mesh of {n} ranks, but the world holds {world}"
                         f" ({len(ranks)} given)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks[:n]).reshape(shape),
                      mesh_dim_names=tuple(names))


def check_mesh(mesh, names: tuple | None = None, ndim: int | None = None
               ) -> None:
    """Raise ValueError unless `mesh` is a DeviceMesh (with axis `names`, or
    `ndim` axes) within the world that holds this rank."""
    if not isinstance(mesh, DeviceMesh):
        raise ValueError(f"mesh: a torch DeviceMesh, got {type(mesh).__name__}")
    got = mesh.mesh_dim_names
    if names is not None and tuple(got or ()) != tuple(names):
        raise ValueError(f"mesh axes {got}, expected {names}")
    if ndim is not None and mesh.ndim != ndim:
        raise ValueError(f"a {mesh.ndim}-D mesh, expected {ndim}-D")
    if mesh.size() > dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size()} ranks, but the world "
                         f"holds {dist.get_world_size()}")
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")


class AllReduce:
    """Sum tensors over one axis of a mesh: one all_reduce of one flat
    buffer for all of them.  The sums are elementwise, so packing changes
    no bit; on a one-rank axis the result is the input.

    Counted in COLLECTIVES under "<stage> <axis>" where it runs, and in
    the record of a CUDA graph capture where it is captured (a replay
    counts it: rso_torch.graphs).  `capturable`: the group is NCCL's, whose
    all_reduce a CUDA graph captures; gloo's runs on the host."""

    def __init__(self, mesh: DeviceMesh, axis: str, stage: str = "solve"):
        self.mesh, self.axis = mesh, axis
        self.group = mesh.get_group(axis)
        self.key = f"{stage} {axis}"
        # "nccl", or a CUDA tensor's backend in "cpu:gloo,cuda:nccl"
        self.capturable = "nccl" in dist.get_backend(self.group)

    def __call__(self, *tensors: torch.Tensor) -> list[torch.Tensor]:
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        count_collective(self.key)
        out, off = [], 0
        for t in tensors:
            out.append(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
        return out

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """gather_slices of `x` over this axis, counted as "gather"."""
        return gather_slices(x, dim, self.mesh, self.axis)


def gather_slices(x: torch.Tensor, dim: int, mesh: DeviceMesh,
                  axis: str) -> torch.Tensor:
    """The whole tensor of which every rank along `axis` holds the slice
    `x`, equal in size, in the order of the ranks along `dim`: an
    all_reduce of a zero-filled buffer with each slice at its place (gloo
    has no all_gather for CUDA tensors).  x + 0 is x, so each slice keeps
    its bits."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * mesh.size(mesh.mesh_dim_names.index(axis))
    full = x.new_zeros(shape)
    full.narrow(dim, mesh.get_local_rank(axis) * n, n).copy_(x)
    return AllReduce(mesh, axis, "gather")(full)[0]
