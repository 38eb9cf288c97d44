"""VO + sliding-window BA pipeline (counterpart of rso/ba/pipeline.py).

Host-side orchestration around the engine step and the BA solve: per-frame
VO -> keyframe policy (driven by the reference's tracked-since-KF counters)
-> window update -> BA refinement of keyframe poses -> trajectory
correction propagated to the running pose.  The engine and the solve run
on the GPU unless the caller passes device="cpu".  A frame reads the step's
result back to the host once, a keyframe its observations once more; a BA
solve then reads one stop flag per block of LM iterations (on one device
the solve replays CUDA graphs: rso_torch.ba.ba.solve_lm).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rso_torch.ba.ba import bundle_adjust
from rso_torch.ba.distributed import distributed_bundle_adjust
from rso_torch.ba.window import KeyframeObs, SlidingWindow, should_make_keyframe
from rso_torch.config import RSOConfig
from rso_torch.engine import Engine, EngineState
from rso_torch.geometry import pose_matrix
from rso_torch.geometry.stereo_camera import StereoCamera
from rso_torch.mesh import check_mesh


def _to_host(tensors) -> list[np.ndarray]:
    """Tensors of one device, read back in one transfer (each as float64,
    which holds int32, bool and float32 values exactly) and returned as
    numpy arrays of their own dtypes and shapes."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    flat = flat.cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        dtype = {torch.bool: bool, torch.int32: np.int32,
                 torch.float32: np.float32}[t.dtype]
        out.append(flat[off:off + n].astype(dtype).reshape(tuple(t.shape)))
        off += n
    return out


def keyframe_obs_from_state(state: EngineState, cfg: RSOConfig,
                            pose_wc: np.ndarray,
                            obs_outlier=None,
                            pose_vo: np.ndarray | None = None) -> KeyframeObs:
    """Extract the current frame's stereo observations + match IDs from the
    engine state (state.prev holds the just-processed frame), in one
    read-back.

    obs_outlier: optional flat [sum(K_o)] bool (tensor or array) from
    StepResult — current-frame match slots whose track was rejected by the
    pose solve; those observations are excluded so aliased landmarks never
    enter the window.
    """
    octs = state.prev.octaves
    tensors = [t for o in octs for t in (o.matches.valid, o.match_ids,
                                         o.left.xy, o.matches.ridx,
                                         o.right.xy)]
    from_device = isinstance(obs_outlier, torch.Tensor)
    if from_device:
        tensors.append(obs_outlier)
    host = _to_host(tensors)
    if obs_outlier is not None:
        obs_outlier = host[-1] if from_device else np.asarray(obs_outlier)

    ids_all, obs_all = [], []
    off = 0
    for o in range(len(octs)):
        valid, match_ids, left_xy, ridx, right_xy = host[5 * o:5 * o + 5]
        scale = float(2 ** o)
        shift = (scale - 1.0) / 2.0
        k_o = valid.shape[0]
        if obs_outlier is not None:
            valid = valid & ~obs_outlier[off:off + k_o]
        off += k_o
        ids = match_ids[valid]
        lxy = left_xy[valid] * scale + shift
        rxy = right_xy[ridx[valid]] * scale + shift
        obs = np.concatenate([lxy, rxy[:, :1], rxy[:, 1:2]], axis=1)
        keep = ids >= 0
        ids_all.append(ids[keep])
        obs_all.append(obs[keep])
    return KeyframeObs(
        pose_wc=np.asarray(pose_wc),
        ids=np.concatenate(ids_all).astype(np.int64),
        obs=np.concatenate(obs_all).astype(np.float32),
        pose_vo=None if pose_vo is None else np.asarray(pose_vo),
    )


def _clamp_transform(G: np.ndarray, max_rot: float,
                     max_trans: float) -> np.ndarray:
    """Scale a rigid transform toward identity (geodesic interpolation
    G -> G^alpha) so its rotation angle <= max_rot and translation norm
    <= max_trans."""
    from scipy.spatial.transform import Rotation

    rv = Rotation.from_matrix(G[:3, :3]).as_rotvec()
    ang = float(np.linalg.norm(rv))
    tn = float(np.linalg.norm(G[:3, 3]))
    alpha = 1.0
    if ang > max_rot > 0:
        alpha = min(alpha, max_rot / ang)
    if tn > max_trans > 0:
        alpha = min(alpha, max_trans / tn)
    if alpha >= 1.0:
        return G
    out = np.eye(4)
    out[:3, :3] = Rotation.from_rotvec(alpha * rv).as_matrix()
    out[:3, 3] = alpha * G[:3, 3]
    return out


class BAFrameResult(NamedTuple):
    pose_wc: np.ndarray      # current camera-to-world (BA-refined lineage)
    vo_valid: bool
    is_keyframe: bool
    ba_cost: float | None


class VOWithBA:
    """Per-frame VO with keyframe-rate sliding-window BA refinement, on the
    GPU by default (raises without CUDA; device="cpu" runs the plain path).
    With a 1-D `mesh` (rso_torch.ba.distributed.make_mesh) every solve
    shards its landmarks over the mesh's ranks, each of which runs this
    pipeline on the same frames; as in the reference, that solve takes no
    marginalization prior."""

    def __init__(self, cfg: RSOConfig, cam: StereoCamera,
                 max_keyframes: int = 8, max_landmarks: int = 1024,
                 ba_iters: int = 15, mesh=None,
                 min_tracked_ratio: float = 0.25, min_tracked_abs: int = 25,
                 min_kf_gap: int = 3, max_correction: float = 0.15,
                 max_rot_correction: float = 0.0035,
                 rel_w_rot: float = 4.0e2, rel_w_trans: float = 25.0,
                 min_obs: int = 2, two_view_weight: float = 0.2,
                 marginalize: bool = False, device="cuda"):
        if mesh is not None:
            check_mesh(mesh, ndim=1)
        self.engine = Engine(cfg, cam, device=device)
        self.cfg = cfg
        self.cam = self.engine.cam
        self.window = SlidingWindow(max_keyframes, max_landmarks,
                                    min_obs=min_obs,
                                    two_view_weight=two_view_weight,
                                    marginalize=marginalize, cam=self.cam,
                                    marg_rel_w=(rel_w_rot, rel_w_trans))
        self.ba_iters = ba_iters
        self.mesh = mesh
        self.min_tracked_ratio = min_tracked_ratio
        self.min_tracked_abs = min_tracked_abs
        self.min_kf_gap = min_kf_gap
        # per-solve caps on the exported correction increment (trust region;
        # see _clamp_transform call): translation metres, rotation radians
        self.max_correction = max_correction
        self.max_rot_correction = max_rot_correction
        # odometry-prior weights (inverse variances, rad^-2 / m^-2): a WEAK
        # anchor of consecutive KFs to their VO relative motion
        self.rel_w_rot = rel_w_rot
        self.rel_w_trans = rel_w_trans
        self._frames_since_kf = 10**9
        self.T = np.eye(4)               # pure VO integration (never fed back)
        self._correction = np.eye(4)     # BA refinement applied to the output

    def process_frame(self, left, right) -> BAFrameResult:
        """VO integrates independently; BA acts as a smoother whose latest
        keyframe correction left-composes onto the VO chain for the OUTPUT
        pose."""
        res = self.engine.process_frame(left, right)
        # the step's pose matrix is formed on the device in float32, as the
        # reference's is
        T_step, valid, total_matches, tracked_kf = _to_host([
            pose_matrix(res.pose), res.valid,
            res.stereo_matches.sum(dtype=torch.int32),
            res.tracked_feats_from_last_KF])
        valid = bool(valid)
        if valid:
            self.T = self.T @ T_step

        total_matches = int(total_matches)
        first = len(self.window) == 0 and total_matches > 0
        self._frames_since_kf += 1
        make_kf = first or (
            valid
            and self._frames_since_kf >= self.min_kf_gap
            and should_make_keyframe(
                int(tracked_kf), total_matches,
                self.min_tracked_ratio, self.min_tracked_abs))
        if make_kf:
            self._frames_since_kf = 0

        ba_cost = None
        if make_kf and self.engine.state is not None:
            T_vo_kf = self.T.copy()
            kf = keyframe_obs_from_state(self.engine.state, self.cfg,
                                         self._correction @ T_vo_kf,
                                         obs_outlier=res.obs_outlier,
                                         pose_vo=T_vo_kf)
            self.window.add_keyframe(kf)
            self.engine.set_this_frame_as_kf()

            if len(self.window) >= 3:
                prob, _ids = self.window.build_problem(self.cam)
                n_shared = int(prob.mask.any(0).sum())
                if n_shared >= 24:
                    rel = self.window.rel_measurements()
                    if self.mesh is not None:
                        out = distributed_bundle_adjust(
                            self.cam, prob, self.mesh,
                            max_iters=self.ba_iters,
                            rel_meas=rel, rel_w_rot=self.rel_w_rot,
                            rel_w_trans=self.rel_w_trans)
                    else:
                        out = bundle_adjust(
                            self.cam, prob, max_iters=self.ba_iters,
                            rel_meas=rel, rel_w_rot=self.rel_w_rot,
                            rel_w_trans=self.rel_w_trans,
                            marg_prior=self.window.prior_terms())
                    cost, refined_poses = _to_host([out.cost, out.poses])
                    ba_cost = float(cost)
                    refined = self.window.apply_result(refined_poses)
                    # trust region on the smoother update: the correction
                    # increment G left-composes onto every future pose, so
                    # clamp its rotation angle / translation norm by
                    # geodesic scaling — frequent small corrections pass
                    # untouched
                    G = refined[-1] @ np.linalg.inv(
                        self._correction @ T_vo_kf)
                    G = _clamp_transform(G, self.max_rot_correction,
                                         self.max_correction)
                    self._correction = G @ self._correction
        return BAFrameResult(pose_wc=self._correction @ self.T,
                             vo_valid=valid,
                             is_keyframe=bool(make_kf), ba_cost=ba_cost)
