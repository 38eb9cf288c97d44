"""Many independent window problems solved at once: windows across the
ranks of a mesh, each window's landmarks across a row of it.

Counterpart of rso/ba/window_sharded.py.  On a ('win','lmk') mesh (ranks
along 'win' stand for hosts, along 'lmk' for a host's cards) each 'win' row
solves its share of the windows, padded to a multiple of the row count, as
the batch dimension of rso_torch.ba.ba's LM loop, with the landmarks
sharded along 'lmk' and summed over 'lmk' only: no collective on 'win'
inside the loop.  A window keeps its whole carry, iteration count
included, once it has converged or run max_iters, while the others go on,
as under the reference's vmap; padded windows start done.  Every window
comes back on every rank at the end, as the reference's out_specs return
them.

mesh=None solves the windows as one batch on the device of their tensors,
with no padding: the reference's make_win_mesh(1, 1) on one device.  Either
way the solve is rso_torch.ba.ba.solve_lm (CUDA graphs on the GPU): on a
mesh over an NCCL group its graph holds the 'lmk' all_reduces and the
landmark gather, and the 'win' gather of the rows' results follows it; on
a gloo group, whose collectives run on the host, the solve runs eagerly,
one stop-flag read per LM block.

split_into_windows and stitch_window_poses are the reference's host code.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from rso_torch.ba.ba import BAProblem, BAResult, solve_lm
from rso_torch.ba.distributed import shard_problem
from rso_torch.geometry.stereo_camera import StereoCamera
from rso_torch.mesh import (
    AllReduce,
    check_mesh,
    ensure_group,
    gather_slices,
    make_device_mesh,
)


def make_win_mesh(n_hosts: int, chips_per_host: int | None = None,
                  devices=None, device="cuda") -> DeviceMesh:
    """('win','lmk') mesh: `n_hosts` rows along 'win', `chips_per_host`
    ranks of each along 'lmk'.  devices: the global ranks to lay out, the
    whole world by default; a process with no process group gets a one-rank
    group on `device`'s backend (see rso_torch.mesh.ensure_group)."""
    ensure_group(device)
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    if chips_per_host is None:
        chips_per_host = len(ranks) // n_hosts
    return make_device_mesh((n_hosts, chips_per_host), ("win", "lmk"),
                            device, ranks)


def stack_problems(probs: list[BAProblem]) -> BAProblem:
    """Stack same-shape window problems along a leading window axis."""
    shapes = {(tuple(p.poses.shape), tuple(p.lmks.shape)) for p in probs}
    if len(shapes) != 1:
        raise ValueError(f"window problems must share shapes, got {shapes}")
    lw = [torch.ones(p.lmks.shape[0], dtype=p.lmks.dtype, device=p.lmks.device)
          if p.lmk_weight is None else p.lmk_weight for p in probs]
    return BAProblem(
        poses=torch.stack([p.poses for p in probs]),
        lmks=torch.stack([p.lmks for p in probs]),
        obs=torch.stack([p.obs for p in probs]),
        mask=torch.stack([p.mask for p in probs]),
        lmk_weight=torch.stack(lw),
    )


def window_sharded_bundle_adjust(
    cam: StereoCamera,
    probs: list[BAProblem],
    mesh=None,
    max_iters: int = 20,
    kernel_param: float = 3.0,
    use_robust: bool = True,
    fix_first: bool = True,
    init_lambda: float = 1e-4,
    tol: float = 1e-5,
    rel_meas: list | None = None,
    rel_w_rot: float = 0.0,
    rel_w_trans: float = 0.0,
) -> list[BAResult]:
    """Solve a batch of independent window problems on the device of their
    tensors, over `mesh` where one is given (every rank of it calling with
    every problem); returns one BAResult per input problem, padding
    stripped, on every rank.

    rel_meas: optional per-window [P-1,6] odometry-prior measurements (the
    same weights apply to every window — they are physical noise levels,
    not per-window tunables); without them a nonzero weight anchors each
    window to zero relative motion, as in the reference.
    """
    W = len(probs)
    stacked = stack_problems(probs)
    dev = stacked.poses.device
    nP = stacked.poses.shape[1]
    if rel_meas is not None:
        rel = torch.stack([torch.as_tensor(r, dtype=torch.float32, device=dev)
                           for r in rel_meas])
    else:
        rel = torch.zeros((W, max(nP - 1, 1), 6), dtype=torch.float32,
                          device=dev)
    args = (max_iters, kernel_param, use_robust, fix_first, init_lambda, tol)
    if mesh is None:
        out = solve_lm(cam, stacked, *args, rel, rel_w_rot, rel_w_trans)
        return [BAResult(*(t[w] for t in out)) for w in range(W)]

    check_mesh(mesh, ("win", "lmk"))
    n_win, n_lmk = mesh.shape
    Wp = -(-W // n_win) * n_win
    L = stacked.lmks.shape[1]
    Lp = -(-L // n_lmk) * n_lmk

    def pad(x, dim, n, fill=0.0):
        shape = list(x.shape)
        shape[dim] = n
        return torch.cat([x, x.new_full(shape, fill)], dim)

    # benign depth for padded landmark slots (z=0 would project to inf)
    far = stacked.lmks.new_tensor([0.0, 0.0, 10.0]).expand(Wp, Lp - L, 3)
    padded = BAProblem(
        poses=pad(stacked.poses, 0, Wp - W),
        lmks=torch.cat([pad(stacked.lmks, 0, Wp - W), far], 1),
        obs=pad(pad(stacked.obs, 0, Wp - W), 2, Lp - L),
        mask=pad(pad(stacked.mask, 0, Wp - W, False), 2, Lp - L, False),
        lmk_weight=pad(pad(stacked.lmk_weight, 0, Wp - W), 1, Lp - L))
    rel = pad(rel, 0, Wp - W)
    active = torch.arange(Wp, device=dev) < W

    # this rank's rows of windows and slice of landmarks
    Wr, Ls = Wp // n_win, Lp // n_lmk
    w0 = mesh.get_local_rank("win") * Wr
    l0 = mesh.get_local_rank("lmk") * Ls
    rows = BAProblem(*(t.narrow(0, w0, Wr) for t in padded))
    out = solve_lm(
        cam.to(dev), shard_problem(rows, l0, Ls), *args,
        rel.narrow(0, w0, Wr), rel_w_rot, rel_w_trans,
        active=active.narrow(0, w0, Wr), reduce=AllReduce(mesh, "lmk"))

    # every window on every rank: the landmarks came back whole over 'lmk'
    # (in the solve), then all of a row's results over 'win'
    parts = [out.poses.flatten(1), out.lmks.flatten(1), out.cost[:, None],
             out.n_iters[:, None].float(), out.converged[:, None].float()]
    full = gather_slices(torch.cat(parts, 1), 0, mesh, "win")
    poses, lmks, cost, iters, done = full.split(
        [p.shape[1] for p in parts], 1)
    poses = poses.reshape(Wp, nP, 6)
    lmks = lmks.reshape(Wp, Lp, 3)
    return [BAResult(poses[w], lmks[w, :L], cost[w, 0],
                     iters[w, 0].to(torch.int32), done[w, 0] > 0)
            for w in range(W)]


# ---- offline long-sequence splitting / stitching -------------------------


def split_into_windows(n_kfs: int, window: int, overlap: int) -> list[range]:
    """Index ranges covering 0..n_kfs-1 with `overlap` shared keyframes
    between consecutive windows (the shared poses let stitching re-anchor
    each window's gauge)."""
    assert 0 < overlap < window
    step = window - overlap
    out = []
    s = 0
    while True:
        e = min(s + window, n_kfs)
        out.append(range(s, e))
        if e >= n_kfs:
            break
        s += step
    return out


def stitch_window_poses(poses6_list: list[np.ndarray],
                        ranges: list[range], overlap: int,
                        n_kfs: int) -> np.ndarray:
    """Chain per-window world->cam pose solutions into one global trajectory.

    Each window is solved in its own gauge (first pose frozen at its VO
    value); window w re-anchors by the rigid transform that maps its FIRST
    keyframe onto the same keyframe's pose in the already-stitched window
    w-1 (they share `overlap` keyframes).  Returns [n_kfs,4,4]
    camera-to-world.
    """
    from scipy.spatial.transform import Rotation

    def t_wc(p6):
        R_cw = Rotation.from_rotvec(np.asarray(p6[:3])).as_matrix()
        T = np.eye(4)
        T[:3, :3] = R_cw.T
        T[:3, 3] = -R_cw.T @ np.asarray(p6[3:])
        return T

    out = [None] * n_kfs
    A = np.eye(4)
    for w, (p6s, rng) in enumerate(zip(poses6_list, ranges)):
        locs = [t_wc(p) for p in np.asarray(p6s)[: len(rng)]]
        if w > 0:
            # anchor: this window's first KF == global index rng.start,
            # already solved by the previous window
            A = out[rng.start] @ np.linalg.inv(locs[0])
        for j, gi in enumerate(rng):
            T = A @ locs[j]
            if out[gi] is None or j >= overlap:
                out[gi] = T
    return np.stack(out)
