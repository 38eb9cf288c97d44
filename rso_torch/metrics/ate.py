"""Trajectory evaluation (host numpy): ATE (absolute trajectory error) and
RPE (relative pose error), a copy of rso/metrics/ate.py, which cannot be
imported here because `rso` loads jax."""
from __future__ import annotations

import numpy as np


def _umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """SE(3) (optionally Sim(3)) alignment of est onto gt positions [N,3]."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    ec = est - mu_e
    gc = gt - mu_g
    C = gc.T @ ec / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / ((ec ** 2).sum() / len(est)) if with_scale else 1.0
    return s, R, mu_g - s * R @ mu_e


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """RMSE of aligned position error. Inputs are [N,4,4] camera-to-world."""
    est = np.asarray(est_poses)[:, :3, 3]
    gt = np.asarray(gt_poses)[:, :3, 3]
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    if align:
        s, R, t = _umeyama_align(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over frame gaps of `delta`.

    Returns (trans_rmse [m], rot_rmse [deg]).
    """
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)
    n = min(len(est), len(gt))
    t_errs, r_errs = [], []
    for i in range(n - delta):
        d_est = np.linalg.inv(est[i]) @ est[i + delta]
        d_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(d_gt) @ d_est
        t_errs.append(np.linalg.norm(e[:3, 3]))
        cosang = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.degrees(np.arccos(cosang)))
    return (float(np.sqrt(np.mean(np.square(t_errs)))),
            float(np.sqrt(np.mean(np.square(r_errs)))))
