"""Offline (batch) trajectory refinement through the batched window solve.

Counterpart of rso/ba/offline.py: a completed VO run's keyframes split into
overlapping windows, all windows solve at once (rso_torch.ba.window_sharded:
over a ('win','lmk') mesh where one is given, else as a batch dimension on
one device), the solved windows stitch back into one trajectory, and each
keyframe's correction propagates to the frames that follow it.
"""
from __future__ import annotations

import numpy as np

from rso_torch.ba.pipeline import keyframe_obs_from_state
from rso_torch.ba.window import KeyframeObs, SlidingWindow
from rso_torch.ba.window_sharded import (
    split_into_windows,
    stitch_window_poses,
    window_sharded_bundle_adjust,
)
from rso_torch.engine import _device
from rso_torch.geometry.stereo_camera import StereoCamera
from rso_torch.mesh import check_mesh


def refine_trajectory(
    cam: StereoCamera,
    kfs: list[KeyframeObs],
    kf_frame_idx: list[int],
    vo_poses: np.ndarray,
    window: int = 8,
    overlap: int = 2,
    mesh=None,
    max_landmarks: int = 256,
    ba_iters: int = 15,
    rel_w_rot: float = 4.0e2,
    rel_w_trans: float = 25.0,
    device="cuda",
) -> np.ndarray:
    """Refine a full trajectory from its keyframe observations.

    vo_poses: [N,4,4] per-frame camera-to-world from the VO run.
    kfs/kf_frame_idx: the keyframes collected during that run (see
    rso_torch.ba.pipeline.keyframe_obs_from_state) and their frame indices.
    Returns [N,4,4] refined camera-to-world poses (vo_poses unchanged when
    there are too few keyframes to form a window).  The windows solve on
    `device`, the GPU unless the caller passes "cpu" (raises without CUDA):
    over `mesh` (rso_torch.ba.window_sharded.make_win_mesh; every rank of
    it calling with the same keyframes) where one is given, else as one
    batch.
    """
    if mesh is not None:
        check_mesh(mesh, ("win", "lmk"))
    dev = _device(device)
    if not isinstance(cam, StereoCamera):
        cam = StereoCamera.from_numpy(cam)
    cam = cam.to(dev)
    n_kf = len(kfs)
    if n_kf < 3:
        return np.asarray(vo_poses).copy()
    window = min(window, n_kf)
    overlap = min(overlap, window - 1)

    ranges = split_into_windows(n_kf, window, overlap)
    if len(ranges[-1]) < window:
        # equal problem shapes for the stacked solve: extend the final
        # window backward (extra overlap is harmless — stitching re-anchors
        # on the first shared keyframe)
        ranges[-1] = range(n_kf - window, n_kf)
    probs, rels = [], []
    for r in ranges:
        win = SlidingWindow(window, max_landmarks, min_obs=2, cam=cam)
        for gi in r:
            win.add_keyframe(kfs[gi])
        prob, _ = win.build_problem(cam)
        probs.append(prob)
        rels.append(win.rel_measurements())

    outs = window_sharded_bundle_adjust(
        cam, probs, mesh, max_iters=ba_iters, rel_meas=rels,
        rel_w_rot=rel_w_rot, rel_w_trans=rel_w_trans)

    stitched = stitch_window_poses(
        [o.poses.cpu().numpy() for o in outs], ranges, overlap, n_kf)

    refined = np.asarray(vo_poses).copy()
    for k, fi in enumerate(kf_frame_idx):
        G = stitched[k] @ np.linalg.inv(vo_poses[fi])
        end = (kf_frame_idx[k + 1] if k + 1 < n_kf else len(refined))
        for j in range(fi, end):
            refined[j] = G @ vo_poses[j]
    return refined


class KeyframeCollector:
    """Per-frame keyframe harvesting for a later refine_trajectory call.

    Drives the same keyframe policy the online pipeline uses but only
    RECORDS the observations — no solve in the loop, so the VO hot path
    stays untouched."""

    def __init__(self, engine, cfg, min_kf_gap: int = 3):
        self.engine = engine
        self.cfg = cfg
        self.min_kf_gap = min_kf_gap
        self.kfs: list[KeyframeObs] = []
        self.kf_frame_idx: list[int] = []
        self._since = 10 ** 9

    def observe(self, frame_idx: int, result, pose_wc: np.ndarray):
        """Call once per processed frame with the engine StepResult and the
        integrated camera-to-world pose."""
        self._since += 1
        total = int(result.stereo_matches.sum())
        if total == 0 or self._since < self.min_kf_gap:
            return False
        self.kfs.append(keyframe_obs_from_state(
            self.engine.state, self.cfg, np.asarray(pose_wc).copy(),
            obs_outlier=result.obs_outlier,
            pose_vo=np.asarray(pose_wc).copy()))
        self.kf_frame_idx.append(frame_idx)
        self.engine.set_this_frame_as_kf()
        self._since = 0
        return True
