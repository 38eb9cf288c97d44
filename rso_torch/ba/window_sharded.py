"""Many independent window problems solved at once, on one device.

Counterpart of rso/ba/window_sharded.py.  The reference shards the window
axis across hosts and each window's landmarks across a host's chips (a
('win','lmk') mesh, shard_map over a vmapped while_loop).  On one GPU the
windows are a batch dimension of rso_torch.ba.ba's LM loop: each window
keeps its whole carry, iteration count included, once it has converged
or run max_iters, while the others go on, as under the reference's vmap.
No landmark padding is needed, and no window is padded.  The mesh forms
(landmark sharding, several devices) come with a later slice of the port.

split_into_windows and stitch_window_poses are the reference's host code.
"""
from __future__ import annotations

import numpy as np
import torch

from rso_torch.ba.ba import BAProblem, BAResult, levenberg_marquardt
from rso_torch.geometry.stereo_camera import StereoCamera

MESH_ERROR = ("rso_torch solves BA on one device: the mesh forms (landmark "
              "sharding, windows across devices) come with a later slice "
              "of the port (ROADMAP Queue 1)")


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
    tensors; returns one BAResult per input problem.

    rel_meas: optional per-window [P-1,6] odometry-prior measurements (the
    same weights apply to every window — they are physical noise levels,
    not per-window tunables); without them a nonzero weight anchors each
    window to zero relative motion, as in the reference.
    """
    if mesh is not None:
        raise ValueError(MESH_ERROR)
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
    out = levenberg_marquardt(cam.to(dev), stacked, max_iters,
                              kernel_param, use_robust, fix_first,
                              init_lambda, tol, rel, rel_w_rot, rel_w_trans)
    return [BAResult(*(t[w] for t in out)) for w in range(W)]


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
