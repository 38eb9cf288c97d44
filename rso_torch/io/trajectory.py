"""Trajectory writers/readers: KITTI and TUM formats.

A copy of rso/io/trajectory.py, which cannot be imported here because
importing any `rso` module loads jax.  The reference demo writes
`camera_pose.txt` as "time x y z yaw pitch roll" (demo-main.cpp:251-253);
these are the two community-standard formats instead, so trajectories feed
straight into evaluation tools.
"""
from __future__ import annotations

import numpy as np


def write_kitti(path: str, poses: np.ndarray) -> None:
    """KITTI format: each line is the top 3x4 of the camera-to-world matrix."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9e}" for v in np.asarray(T)[:3, :4].ravel()) + "\n")


def read_kitti(path: str) -> np.ndarray:
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (raw.shape[0], 1, 1))
    out[:, :3, :] = raw
    return out


def write_tum(path: str, poses: np.ndarray, timestamps=None) -> None:
    """TUM format: time tx ty tz qx qy qz qw."""
    from scipy.spatial.transform import Rotation

    n = len(poses)
    ts = timestamps if timestamps is not None else np.arange(n, dtype=float)
    with open(path, "w") as f:
        for t, T in zip(ts, poses):
            T = np.asarray(T)
            q = Rotation.from_matrix(T[:3, :3]).as_quat()  # x,y,z,w
            tr = T[:3, 3]
            f.write(f"{t:.6f} {tr[0]:.6f} {tr[1]:.6f} {tr[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def read_tum(path: str):
    rows = np.loadtxt(path)
    from scipy.spatial.transform import Rotation

    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :3] = Rotation.from_quat(rows[:, 4:8]).as_matrix()
    poses[:, :3, 3] = rows[:, 1:4]
    return rows[:, 0], poses


def integrate_relative(rel_poses) -> np.ndarray:
    """Compose per-frame relative poses T_{prev<-cur} into camera-to-world
    (the demo loop's pose composition, demo-main.cpp:235-243)."""
    T = np.eye(4)
    out = [T.copy()]
    for d in rel_poses:
        T = T @ np.asarray(d)
        out.append(T.copy())
    return np.stack(out)
