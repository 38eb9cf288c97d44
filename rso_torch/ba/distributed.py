"""Distributed sliding-window BA: landmark-sharded Schur reduction on a mesh.

Counterpart of rso/ba/distributed.py.  Landmarks shard across the mesh's
one axis ('lmk'): every rank assembles the normal-equation blocks of its
landmark shard, the reduced camera system is summed over the ranks, the
small [P*6, P*6] solve runs replicated on every rank, and the landmark
back-substitution is local to each shard.  The loop is rso_torch.ba.ba's
levenberg_marquardt with its `reduce` seam: where the reference runs six
psums an LM iteration, the port packs them into two all_reduces, one for
the system (g_p, H_pp, the Schur cross term, W g_l: P*P*36 + P*42 floats)
and one for the cost with the count of non-finite landmarks.  It runs as
rso_torch.ba.ba.solve_lm, the counterpart of the reference's
jax.jit(shard_map(...)): on an NCCL group one CUDA graph launch a solve,
the all_reduces and the landmark gather inside it and the loop's stop flag
tested on the device (every rank takes the same decisions, so every rank
runs the same iterations and collectives); on a gloo group, whose
collectives run on the host, the same solve eagerly, one flag read a block
of LM iterations.

SPMD: one process per device (rso_torch.ba.multihost), every rank calling
with the whole problem, as each process does in the reference's
multi-process run; each keeps its slice of the landmarks.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from rso_torch.ba.ba import BAProblem, BAResult, solve_lm
from rso_torch.geometry.stereo_camera import StereoCamera
from rso_torch.mesh import AllReduce, check_mesh, ensure_group, make_device_mesh


def make_mesh(n_devices: int | None = None, axis: str = "lmk",
              device="cuda") -> DeviceMesh:
    """A 1-D mesh over the first `n_devices` ranks of the world (all of
    them by default).  In a process with no process group: a one-rank group
    on `device`'s backend (NCCL on the GPU unless the caller passes
    device="cpu"; raises without CUDA)."""
    ensure_group(device)
    return make_device_mesh((n_devices or dist.get_world_size(),), (axis,),
                            device)


def pad_problem(prob: BAProblem, n_shards: int) -> BAProblem:
    """Pad the landmark axis to a multiple of the shard count."""
    L = prob.lmks.shape[0]
    Lp = ((L + n_shards - 1) // n_shards) * n_shards
    if Lp == L:
        return prob
    pad = Lp - L
    # pad landmarks at a benign depth (z=10): zero-depth slots would project
    # to inf and pollute masked reductions
    pad_lmks = prob.lmks.new_tensor([[0.0, 0.0, 10.0]]).expand(pad, 3)

    def zeros(x, dim):
        return torch.cat([x, x.new_zeros(x.shape[:dim] + (pad,)
                                         + x.shape[dim + 1:])], dim)

    return BAProblem(
        poses=prob.poses,
        lmks=torch.cat([prob.lmks, pad_lmks]),
        obs=zeros(prob.obs, 1),
        mask=zeros(prob.mask, 1),
        lmk_weight=(None if prob.lmk_weight is None
                    else zeros(prob.lmk_weight, 0)),
    )


def shard_problem(prob: BAProblem, start: int, n: int) -> BAProblem:
    """Landmarks [start, start+n) of a problem (leading batch dims kept)."""
    return BAProblem(
        poses=prob.poses,
        lmks=prob.lmks.narrow(-2, start, n),
        obs=prob.obs.narrow(-2, start, n),
        mask=prob.mask.narrow(-1, start, n),
        lmk_weight=(None if prob.lmk_weight is None
                    else prob.lmk_weight.narrow(-1, start, n)),
    )


def distributed_bundle_adjust(
    cam: StereoCamera,
    prob: BAProblem,
    mesh: DeviceMesh,
    max_iters: int = 20,
    kernel_param: float = 3.0,
    use_robust: bool = True,
    fix_first: bool = True,
    init_lambda: float = 1e-4,
    tol: float = 1e-5,
    rel_meas=None,
    rel_w_rot: float = 0.0,
    rel_w_trans: float = 0.0,
) -> BAResult:
    """LM BA with the landmark axis sharded over `mesh`'s one axis, on the
    device of `prob`; every rank of the mesh calls it with the whole
    problem.

    Returns the reference's shapes on every rank: the landmarks padded to a
    multiple of the shard count.  rel_meas/rel_w_* enable the odometry
    prior (see rso_torch.ba.ba.bundle_adjust); it is pose-only, so every
    rank computes it, after the reduction: no extra communication.  On a
    one-rank mesh the result equals bundle_adjust's bit for bit.  A solve
    on an NCCL group is one CUDA graph launch after the first of its
    shapes; on a gloo group it runs eagerly (rso_torch.ba.ba.solve_lm).
    """
    check_mesh(mesh, ndim=1)
    axis = mesh.mesh_dim_names[0]
    n_shards = mesh.size()
    prob = pad_problem(prob, n_shards)
    Lp = prob.lmks.shape[0]
    n = Lp // n_shards
    start = mesh.get_local_rank(axis) * n
    dev = prob.poses.device
    if rel_meas is not None:
        rel_meas = torch.as_tensor(rel_meas, dtype=torch.float32, device=dev)
    return solve_lm(cam.to(dev), shard_problem(prob, start, n), max_iters,
                    kernel_param, use_robust, fix_first, init_lambda, tol,
                    rel_meas, rel_w_rot, rel_w_trans,
                    reduce=AllReduce(mesh, axis))
