"""Sliding keyframe window: host-side bookkeeping feeding the BA solver.

Counterpart of rso/ba/window.py, the same numpy code: landmark identity is
the stereo-match ID, each keyframe contributes its stereo observations of
the IDs it sees; fixed capacities W keyframes x L landmark slots,
oldest-keyframe eviction (optionally marginalized into a prior), landmark
slots recycled when no keyframe in the window observes the ID anymore.
`build_problem` builds the reference's arrays bit for bit and puts them on
the camera's device; `prior_terms`, `rel_measurements` and `apply_result`
stay numpy.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rso_torch.ba.ba import BAProblem
from rso_torch.ba.marginalization import host_camera, marginalize_oldest
from rso_torch.geometry.stereo_camera import StereoCamera


def _pose6_of(T_wc: np.ndarray) -> np.ndarray:
    """world->cam (rotvec, t) 6-vector from a camera-to-world matrix."""
    from scipy.spatial.transform import Rotation

    R_cw = np.asarray(T_wc, np.float64)[:3, :3].T
    t_cw = -R_cw @ np.asarray(T_wc, np.float64)[:3, 3]
    return np.concatenate([Rotation.from_matrix(R_cw).as_rotvec(),
                           t_cw]).astype(np.float32)


class KeyframeObs(NamedTuple):
    """One keyframe's contribution: stereo observations keyed by match ID."""

    pose_wc: np.ndarray     # [4,4] camera-to-world (current best estimate)
    ids: np.ndarray         # [N] int64 match IDs
    obs: np.ndarray         # [N,4] (uL,vL,uR,vR) full-resolution coords
    pose_vo: np.ndarray | None = None  # [4,4] pure-VO camera-to-world at this
    # KF — the measurement behind the odometry prior (never BA-refined)


class SlidingWindow:
    def __init__(self, max_keyframes: int = 8, max_landmarks: int = 1024,
                 min_obs: int = 2, two_view_weight: float = 0.2,
                 marginalize: bool = False, cam: StereoCamera | None = None,
                 marg_rel_w: tuple[float, float] = (0.0, 0.0),
                 kernel_param: float = 3.0):
        self.W = max_keyframes
        self.L = max_landmarks
        self.min_obs = min_obs  # KFs that must observe a landmark for a slot
        # landmarks seen by exactly 2 KFs are kept (dropping them starves the
        # problem on straight runs) but down-weighted: during fast rotation
        # their triangulation noise dominates and biases the window rotation
        self.two_view_weight = two_view_weight
        # marginalization-on-eviction: evicted pose + dying landmarks become
        # a Gaussian prior over the remaining poses instead of being dropped
        self.marginalize = marginalize
        self.cam = cam
        self.marg_rel_w = marg_rel_w
        self.kernel_param = kernel_param
        self.prior = None  # MargPrior | None, covers keyframes[:prior.n]
        self.keyframes: list[KeyframeObs] = []

    def add_keyframe(self, kf: KeyframeObs):
        self.keyframes.append(kf)
        if len(self.keyframes) > self.W:
            if self.marginalize and self.cam is not None:
                self.prior = marginalize_oldest(
                    self.cam, self.keyframes, self.prior,
                    min_obs=self.min_obs,
                    two_view_weight=self.two_view_weight,
                    kernel_param=self.kernel_param,
                    rel_w=self.marg_rel_w)
            self.keyframes.pop(0)  # oldest out (info kept in self.prior)

    def prior_terms(self):
        """The marginalization prior aligned to the CURRENT window: returns
        (H [P,6,P,6], b [P,6], lin [P,6]) float32 or None.  Keyframes newer
        than the prior (appended since the last eviction) get zero blocks;
        their lin entry is their current pose so dx = 0 there."""
        if self.prior is None or self.prior.n == 0:
            return None
        P = len(self.keyframes)
        n = min(self.prior.n, P)
        H = np.zeros((P * 6, P * 6), np.float32)
        b = np.zeros(P * 6, np.float32)
        lin = np.stack([_pose6_of(kf.pose_wc) for kf in self.keyframes])
        H[: n * 6, : n * 6] = self.prior.H[: n * 6, : n * 6]
        b[: n * 6] = self.prior.b[: n * 6]
        lin[:n] = self.prior.lin[:n]
        return (H.reshape(P, 6, P, 6), b.reshape(P, 6),
                lin.astype(np.float32))

    def __len__(self):
        return len(self.keyframes)

    def build_problem(self, cam: StereoCamera) -> tuple[BAProblem, np.ndarray]:
        """Assemble the fixed-shape BAProblem on the camera's device (+ the
        landmark-slot -> ID map).

        Landmarks observed by >= 2 keyframes get slots (single-view points
        carry no BA information beyond their anchor); initial positions are
        triangulated from the first observing keyframe and transformed to
        world frame.
        """
        from collections import Counter

        from scipy.spatial.transform import Rotation

        P = len(self.keyframes)
        assert P >= 2, "window BA needs at least 2 keyframes"

        counts = Counter()
        for kf in self.keyframes:
            counts.update(kf.ids.tolist())
        shared = [i for i, c in counts.items() if c >= self.min_obs]
        shared = shared[: self.L]
        slot_of = {i: s for s, i in enumerate(shared)}
        nL = len(shared)
        lmk_weight = np.ones(self.L, np.float32)
        for s, i in enumerate(shared):
            if counts[i] == 2:
                lmk_weight[s] = self.two_view_weight

        obs = np.zeros((P, self.L, 4), np.float32)
        mask = np.zeros((P, self.L), bool)
        poses = np.zeros((P, 6), np.float32)
        lmks = np.zeros((self.L, 3), np.float32)
        lmk_set = np.zeros(self.L, bool)

        hc = host_camera(cam)
        fx_l = hc.fx_l
        cx_l, cy_l = hc.cx_l, hc.cy_l
        fx_r, cx_r = hc.fx_r, hc.cx_r
        baseline = hc.baseline

        for p, kf in enumerate(self.keyframes):
            T = kf.pose_wc
            R_cw = T[:3, :3].T
            t_cw = -R_cw @ T[:3, 3]
            poses[p, :3] = Rotation.from_matrix(R_cw).as_rotvec()
            poses[p, 3:] = t_cw
            for i, (mid, ob) in enumerate(zip(kf.ids, kf.obs)):
                s = slot_of.get(int(mid))
                if s is None:
                    continue
                obs[p, s] = ob
                mask[p, s] = True
                if not lmk_set[s]:
                    ul, vl, ur = ob[0], ob[1], ob[2]
                    denom = fx_l * (cx_r - ur) + fx_r * (ul - cx_l)
                    if abs(denom) < 1e-9:
                        continue
                    b_d = baseline / denom
                    Xc = np.array([b_d * fx_r * (ul - cx_l),
                                   b_d * fx_r * (vl - cy_l),
                                   b_d * fx_l * fx_r])
                    lmks[s] = T[:3, :3] @ Xc + T[:3, 3]  # cam -> world
                    lmk_set[s] = True

        mask &= lmk_set[None, :]
        dev = cam.fx_l.device
        prob = BAProblem(*(torch.from_numpy(a).to(dev) for a in
                           (poses, lmks, obs, mask, lmk_weight)))
        return prob, np.array(shared + [-1] * (self.L - nL), np.int64)

    def rel_measurements(self) -> np.ndarray | None:
        """VO-measured consecutive relative transforms [P-1,6] (w,t of
        T_rel = inv(T_vo_{p+1}) @ T_vo_p, mapping cam_p -> cam_{p+1} in
        world->cam convention) for the odometry prior.  None when any
        keyframe lacks a pose_vo."""
        if len(self.keyframes) < 2:
            return None
        if any(kf.pose_vo is None for kf in self.keyframes):
            return None
        from scipy.spatial.transform import Rotation

        out = []
        for a, b in zip(self.keyframes[:-1], self.keyframes[1:]):
            T_rel = np.linalg.inv(b.pose_vo) @ a.pose_vo
            out.append(np.concatenate([
                Rotation.from_matrix(T_rel[:3, :3]).as_rotvec(),
                T_rel[:3, 3]]))
        return np.stack(out).astype(np.float32)

    def apply_result(self, poses6: np.ndarray):
        """Write optimized world->cam poses back as camera-to-world matrices."""
        from scipy.spatial.transform import Rotation

        out = []
        for p, kf in enumerate(self.keyframes):
            R_cw = Rotation.from_rotvec(np.asarray(poses6[p, :3])).as_matrix()
            t_cw = np.asarray(poses6[p, 3:])
            T = np.eye(4)
            T[:3, :3] = R_cw.T
            T[:3, 3] = -R_cw.T @ t_cw
            out.append(T)
            self.keyframes[p] = kf._replace(pose_wc=T)
        return np.stack(out)


def should_make_keyframe(tracked_from_last_kf: int, total_matches: int,
                         min_tracked_ratio: float = 0.5,
                         min_tracked_abs: int = 40) -> bool:
    """Keyframe policy driven by the reference's KF counters
    (tracked_feats_from_last_KF, libstereo-odometry.h:245): promote when the
    surviving-KF-track fraction decays."""
    if total_matches == 0:
        return True
    return (tracked_from_last_kf < min_tracked_abs
            or tracked_from_last_kf < min_tracked_ratio * total_matches)
