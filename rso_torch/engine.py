"""The odometry engine: EngineState + one per-frame step, on one device.

Counterpart of rso/engine.py (`init_state`, `make_step`, `Engine`) for the
default configuration: grayscale + 3-octave pyramid (stage 1), dmFASTER
detection (stage 2), SAD stereo matching (stage 3), SAD inter-frame tracking,
the flat two-eye fundamental-matrix RANSAC, match-ID propagation, the
bad-tracking gate, stage-5 NMS, the two-phase robust pose solve, error codes
and the bounded keep-prev recovery (`_tail`).

The reference runs the step as one jitted XLA program; here it is eager
PyTorch on the state's device, with the four CUDA kernels under it.  The
state lives on the device between frames, and the step reads nothing back to
the host except the pose solver's per-iteration stop flag.

Configurations outside this slice raise NotImplementedError naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from rso_torch import random as rrandom
from rso_torch.config import (
    DetectMethod,
    IFMatchMethod,
    NMSMethod,
    RSOConfig,
    StereoMatchMethod,
)
from rso_torch.frontend.detect import (
    Features,
    detect_features,
    octave_budget,
    octave_k_slots,
    update_fast_threshold,
)
from rso_torch.frontend.pyramid import build_pyramid, to_grayscale
from rso_torch.frontend.stereo_match import StereoMatches, match_left_right
from rso_torch.frontend.track import TrackResult, track_interframe
from rso_torch.geometry.stereo_camera import StereoCamera
from rso_torch.solver.ransac import ransac_fundamental
from rso_torch.solver.robust_gn import (
    VOEC_BAD_COND_NUMBER,
    VOEC_BAD_TRACKING,
    VOEC_FIRST_ITERATION,
    VOEC_NONE,
    solve_pose,
)


class OctaveData(NamedTuple):
    """Everything the engine keeps about one octave of one frame."""

    left: Features
    right: Features
    matches: StereoMatches
    match_ids: torch.Tensor  # [K] int32, -1 for invalid slots


class FrameView(NamedTuple):
    octaves: tuple  # tuple[OctaveData, ...], one per octave


class EngineState(NamedTuple):
    prev: FrameView
    prev_pyr_l: tuple             # empty in this slice (flow / detect_every)
    prev_pyr_r: tuple
    have_prev: torch.Tensor       # bool
    since_detect: torch.Tensor    # int32
    last_match_id: torch.Tensor   # int32
    last_kf_max_id: torch.Tensor  # int32
    last_pose: torch.Tensor       # [6] f32
    fast_th: torch.Tensor         # [O] int32
    last_error: torch.Tensor      # int32
    err_streak: torch.Tensor      # int32: consecutive keep-prev recoveries
    frame_idx: torch.Tensor       # int32


class StepResult(NamedTuple):
    """Mirrors TStereoOdometryResult (libstereo-odometry.h:235-264)."""

    pose: torch.Tensor                          # [6] cur frame wrt previous
    valid: torch.Tensor                         # bool
    error_code: torch.Tensor                    # int32 VOEC_*
    num_it: torch.Tensor                        # int32
    num_it_final: torch.Tensor                  # int32
    detected_feats: torch.Tensor                # [O,2] int32 (left,right)
    stereo_matches: torch.Tensor                # [O] int32
    tracked_feats_from_last_frame: torch.Tensor  # int32
    tracked_feats_from_last_KF: torch.Tensor     # int32
    residuals: torch.Tensor                     # [T] f32 squared residuals
    track_mask: torch.Tensor                    # [T] bool slots in stage 5
    inliers: torch.Tensor                       # [T] bool final inliers
    cost: torch.Tensor                          # f32 final robust cost
    obs_outlier: torch.Tensor                   # [T] bool cur slots cut as outliers


def _tree_map(fn, *trees):
    """Map fn over the tensor leaves of matching NamedTuple/tuple trees."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    mapped = [_tree_map(fn, *xs) for xs in zip(*trees)]
    return type(t0)(*mapped) if hasattr(t0, "_fields") else tuple(mapped)


def _int(v, device) -> torch.Tensor:
    # a fill kernel, not a host-to-device copy (which would sync the stream)
    return torch.full((), v, dtype=torch.int32, device=device)


def _empty_features(k: int, device) -> Features:
    return Features(
        xy=torch.zeros((k, 2), dtype=torch.float32, device=device),
        response=torch.zeros((k,), dtype=torch.float32, device=device),
        valid=torch.zeros((k,), dtype=torch.bool, device=device),
        desc=torch.zeros((k, 8), dtype=torch.int32, device=device),
        patch=torch.zeros((k, 64), dtype=torch.float32, device=device),
    )


def _empty_octave(k: int, device) -> OctaveData:
    return OctaveData(
        left=_empty_features(k, device),
        right=_empty_features(k, device),
        matches=StereoMatches(
            ridx=torch.full((k,), -1, dtype=torch.int32, device=device),
            dist=torch.zeros((k,), dtype=torch.float32, device=device),
            valid=torch.zeros((k,), dtype=torch.bool, device=device),
        ),
        match_ids=torch.full((k,), -1, dtype=torch.int32, device=device),
    )


def _check_slice(cfg: RSOConfig, rectify_maps=None, precomputed=None) -> None:
    """Raise for every configuration this slice of the port does not run."""
    def todo(what, item):
        raise NotImplementedError(f"{what} is not ported yet "
                                  f"(ROADMAP Queue 1 #{item})")

    if rectify_maps is not None:
        todo("rectification (rectify_maps)", 12)
    if precomputed:
        todo(f"precomputed={precomputed!r} injection", 15)
    if cfg.tpu.detect_every > 1:
        todo("detect_every > 1 (LK propagation)", 14)
    if cfg.if_match.ifm_method == IFMatchMethod.OPTICAL_FLOW:
        todo("ifm_method OPTICAL_FLOW", 14)
    if cfg.if_match.ifm_method != IFMatchMethod.SAD:
        todo(f"ifm_method {cfg.if_match.ifm_method!r}", 13)
    if cfg.detect.detect_method != DetectMethod.FASTER:
        todo(f"detect_method {cfg.detect.detect_method!r}", 13)
    if cfg.lr_match.match_method != StereoMatchMethod.SAD:
        todo(f"match_method {cfg.lr_match.match_method!r}", 13)
    if (cfg.detect.non_maximal_suppression
            and cfg.detect.nmsMethod == NMSMethod.ADAPTIVE):
        todo("adaptive NMS", 13)
    if cfg.tpu.subpixel_track_refine:
        todo("subpixel_track_refine", 11)
    if cfg.least_squares.solve_backend != "chol" or cfg.least_squares.use_lm:
        todo("the eigh solve backend and LM damping", 8)


def init_state(cfg: RSOConfig, img_hw: tuple | None = None,
               device="cpu") -> EngineState:
    """The state before the first frame.  The FAST threshold starts at the
    config's initial_FAST_threshold for every octave."""
    _check_slice(cfg)
    O = cfg.n_octaves
    Ks = octave_k_slots(cfg.detect.orb_nfeats, O, cfg.tpu.max_kps_per_octave,
                        cfg.tpu.octave_slot_decay)
    return EngineState(
        prev=FrameView(octaves=tuple(_empty_octave(k, device) for k in Ks)),
        prev_pyr_l=(),
        prev_pyr_r=(),
        have_prev=torch.zeros((), dtype=torch.bool, device=device),
        since_detect=_int(0, device),
        last_match_id=_int(0, device),
        last_kf_max_id=_int(-1, device),
        last_pose=torch.zeros(6, dtype=torch.float32, device=device),
        fast_th=torch.full((O,), cfg.detect.initial_FAST_threshold,
                           dtype=torch.int32, device=device),
        last_error=_int(VOEC_NONE, device),
        err_streak=_int(0, device),
        frame_idx=_int(0, device),
    )


def state_from_numpy(tree, device="cpu") -> EngineState:
    """The reference's EngineState, every leaf passed through np.asarray, as
    this package's EngineState on `device` — the bridge that lets a test
    start the port from exactly the state the reference reached.  The
    reference's uint32 descriptor words become int32 with the same bits."""
    def leaf(x):
        a = np.array(x, order="C")          # a writable copy, 0-d kept 0-d
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(device)

    def feats(f):
        return Features(*(leaf(getattr(f, n)) for n in Features._fields))

    octaves = tuple(
        OctaveData(left=feats(o.left), right=feats(o.right),
                   matches=StereoMatches(*(leaf(getattr(o.matches, n))
                                           for n in StereoMatches._fields)),
                   match_ids=leaf(o.match_ids))
        for o in tree.prev.octaves)
    scalars = {n: leaf(getattr(tree, n)) for n in EngineState._fields
               if n not in ("prev", "prev_pyr_l", "prev_pyr_r")}
    return EngineState(prev=FrameView(octaves=octaves),
                       prev_pyr_l=tuple(leaf(p) for p in tree.prev_pyr_l),
                       prev_pyr_r=tuple(leaf(p) for p in tree.prev_pyr_r),
                       **scalars)


def _assign_new_ids(match_valid, tracked_mask, prop_ids, last_match_id):
    """Tracked slots keep their propagated ids; untracked valid matches get
    new sequential ids (reference stage4:296-305, stage3:406-407)."""
    need_new = match_valid & ~tracked_mask
    rank = torch.cumsum(need_new.to(torch.int32), dim=0, dtype=torch.int32) - 1
    new_ids = last_match_id + rank
    minus1 = torch.full_like(prop_ids, -1)
    ids = torch.where(tracked_mask, prop_ids,
                      torch.where(need_new, new_ids, minus1))
    return ids, last_match_id + need_new.sum(dtype=torch.int32)


def _stage5_nms(xy, resp, mask, min_distance):
    """Spatial decimation of the optimisation set: a point survives unless a
    strictly better one (response, then slot index) lies within
    ~min_distance/2 (dense [T,T] compare)."""
    r = max(float(min_distance) / 2.0, 1.0)
    T = xy.shape[0]
    idx = torch.arange(T, device=xy.device)
    d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
    better = (resp[None, :] > resp[:, None]) | (
        (resp[None, :] == resp[:, None]) & (idx[None, :] < idx[:, None]))
    kill = mask[None, :] & better & (d2 < r * r)
    return mask & ~kill.any(dim=1)


def make_step(cfg: RSOConfig, cam: StereoCamera, img_h: int, img_w: int,
              rectify_maps=None, precomputed: str | None = None):
    """Build the per-frame step for a fixed config and image size:
    step(state, left_img, right_img) -> (state', StepResult)."""
    _check_slice(cfg, rectify_maps, precomputed)
    O = cfg.n_octaves
    budgets = octave_budget(cfg.detect.orb_nfeats, O)
    Ks = octave_k_slots(cfg.detect.orb_nfeats, O, cfg.tpu.max_kps_per_octave,
                        cfg.tpu.octave_slot_decay)
    offs = np.cumsum([0] + Ks).tolist()
    min_response = 0.0  # reference stage3:188-193 for FAST detectors
    # the z-gate's octave-scaled fx*baseline, from the f32 camera entries
    fx_baseline = [float(cam.fx_l) * float(cam.baseline) / (2 ** o)
                   if cfg.lr_match.use_z_gate else None for o in range(O)]
    # per-octave fundamental-matrix filtering is off: one flat filter runs
    # over all octaves in _tail
    ifm = dataclasses.replace(cfg.if_match, filter_fund_matrix=False)
    ls = cfg.least_squares

    def _stage_2(state, pyr_l, pyr_r):
        octs, new_fast_th, detected = [], [], []
        for o in range(O):
            th = state.fast_th[o]
            fl = detect_features(pyr_l[o], cfg.detect, Ks[o], th, False,
                                 arc=cfg.tpu.fast_arc)
            fr = detect_features(pyr_r[o], cfg.detect, Ks[o], th, False,
                                 arc=cfg.tpu.fast_arc)
            # octave budget: keep only the strongest budget[o] slots
            slot_ok = torch.arange(Ks[o], device=th.device) < budgets[o]
            fl = fl._replace(valid=fl.valid & slot_ok)
            fr = fr._replace(valid=fr.valid & slot_ok)
            octs.append((fl, fr))
            n_left = fl.valid.sum(dtype=torch.int32)
            detected.append(torch.stack([n_left,
                                         fr.valid.sum(dtype=torch.int32)]))
            if cfg.detect.update_dyn_thresholds:
                area = pyr_l[o].shape[0] * pyr_l[o].shape[1]
                th = update_fast_threshold(th, n_left, area, cfg.detect)
            new_fast_th.append(th)
        return octs, new_fast_th, detected

    def _stage_3(octs):
        cur_octs, n_matches = [], []
        for o in range(O):
            fl, fr = octs[o]
            m = match_left_right(fl, fr, cfg.lr_match, img_w >> o,
                                 min_response, fx_baseline=fx_baseline[o])
            cur_octs.append(OctaveData(
                left=fl, right=fr, matches=m,
                match_ids=torch.full((Ks[o],), -1, dtype=torch.int32,
                                     device=m.ridx.device)))
            n_matches.append(m.valid.sum(dtype=torch.int32))
        return cur_octs, n_matches

    def step(state: EngineState, left_img, right_img):
        pyr_l = build_pyramid(to_grayscale(left_img), O)
        pyr_r = build_pyramid(to_grayscale(right_img), O)
        octs, new_fast_th, detected = _stage_2(state, pyr_l, pyr_r)
        cur_octs, n_matches = _stage_3(octs)
        return _tail(state, cur_octs, n_matches, detected, new_fast_th)

    def _tail(state, cur_octs, n_matches, detected, new_fast_th):
        dev = state.last_pose.device

        # ---- stage 4: inter-frame tracking ----------------------------------
        tracks = []
        for o in range(O):
            p, c = state.prev.octaves[o], cur_octs[o]
            trk = track_interframe(p.left, p.right, p.matches, c.left,
                                   c.right, c.matches, ifm, key=None,
                                   ransac_iters=cfg.tpu.ransac_iters,
                                   ransac_threshold=cfg.tpu.ransac_threshold)
            trk_valid = trk.valid & state.have_prev   # no prev -> no tracks
            trk_idx = torch.where(trk_valid, trk.cur_idx,
                                  torch.full_like(trk.cur_idx, -1))
            tracks.append(TrackResult(cur_idx=trk_idx, valid=trk_valid,
                                      n_tracked=trk_valid.sum(dtype=torch.int32)))

        # ---- gather tracks into the flat cross-octave set --------------------
        prev_obs_l, cur_obs_l, resp_l, mask_l, w_l = [], [], [], [], []
        for o in range(O):
            p, c, trk = state.prev.octaves[o], cur_octs[o], tracks[o]
            # octave-o pixel centres sit at 2^o*x + (2^o-1)/2 at full res
            scale = float(2 ** o)
            shift = (scale - 1.0) / 2.0
            p_ridx = torch.clamp(p.matches.ridx.to(torch.int64), min=0)
            pR_xy = p.right.xy[p_ridx]
            prev_obs_l.append(torch.cat([p.left.xy, pR_xy], dim=1) * scale
                              + shift)
            safe_c = torch.clamp(trk.cur_idx.to(torch.int64), min=0)
            c_ridx = torch.clamp(c.matches.ridx.to(torch.int64)[safe_c], min=0)
            cur_obs_l.append(torch.cat([c.left.xy[safe_c], c.right.xy[c_ridx]],
                                       dim=1) * scale + shift)
            resp_l.append(p.left.response)
            mask_l.append(trk.valid)
            # octave-o pixel noise is 2^o x larger at full res: weight 1/4^o
            w_l.append(torch.full((Ks[o],), 1.0 / (scale * scale),
                                  dtype=torch.float32, device=dev))
        prev_obs = torch.cat(prev_obs_l)   # [T,4]
        cur_obs = torch.cat(cur_obs_l)
        resp = torch.cat(resp_l)
        tmask = torch.cat(mask_l)
        obs_w = torch.cat(w_l)

        # one flat fundamental-matrix filter over all octaves, both eyes
        if cfg.if_match.filter_fund_matrix:
            key = rrandom.fold_in(rrandom.PRNGKey(7, dev), state.frame_idx)
            keys = rrandom.split(rrandom.fold_in(key, 1000))
            res2 = ransac_fundamental(
                torch.stack([prev_obs[:, :2], prev_obs[:, 2:4]]),
                torch.stack([cur_obs[:, :2], cur_obs[:, 2:4]]),
                tmask, keys, n_iters=cfg.tpu.ransac_iters,
                threshold=cfg.tpu.ransac_threshold)
            both = res2.inliers[0] & res2.inliers[1]
            tmask = torch.where(res2.ok[0] & res2.ok[1], both, tmask)

        # ---- ID propagation with the post-filter tracks ----------------------
        n_tracked_total = tmask.sum(dtype=torch.int32)
        n_tracked_kf = _int(0, dev)
        last_id = state.last_match_id
        final_octs, claims_l = [], []
        for o in range(O):
            p, c = state.prev.octaves[o], cur_octs[o]
            trk_ok = tmask[offs[o]:offs[o + 1]]
            # route prev ids to tracked cur slots (tracks are 1-to-1, so each
            # cur slot has at most one claimant); invalid entries point at
            # Ks[o], outside the slot range
            tgt = torch.where(trk_ok, tracks[o].cur_idx,
                              torch.full_like(tracks[o].cur_idx, Ks[o]))
            claims = tgt[:, None] == torch.arange(Ks[o], dtype=torch.int32,
                                                  device=dev)[None, :]
            claims_l.append(claims)
            prop_ids = torch.where(claims, p.match_ids[:, None],
                                   torch.full_like(claims, -1,
                                                   dtype=torch.int32)).amax(dim=0)
            ids, last_id = _assign_new_ids(c.matches.valid, claims.any(dim=0),
                                           prop_ids, last_id)
            final_octs.append(c._replace(match_ids=ids))
            n_tracked_kf = n_tracked_kf + ((ids >= 0) & (
                ids <= state.last_kf_max_id)).sum(dtype=torch.int32)
        cur_view = FrameView(octaves=tuple(final_octs))

        # ---- stage 4.1: robustness gate + stage 5 ---------------------------
        bad_tracking = state.have_prev & (n_tracked_total < ls.bad_tracking_th)
        smask = tmask & _stage5_nms(prev_obs[:, :2], resp, tmask,
                                    cfg.detect.min_distance)
        init_pose = (state.last_pose if ls.use_previous_pose_as_initial
                     else torch.zeros_like(state.last_pose))
        sol = solve_pose(cam, prev_obs, cur_obs, smask, ls,
                         initial_pose=init_pose, obs_weight=obs_w)

        # per-CURRENT-slot outlier flags (dense one-hot routing, as above)
        outlier_prev = smask & ~sol.inliers
        obs_outlier = torch.cat([
            (claims_l[o] & outlier_prev[offs[o]:offs[o + 1], None]).any(dim=0)
            for o in range(O)])

        # ---- error codes & result -------------------------------------------
        first = ~state.have_prev
        error_code = torch.where(
            first, VOEC_FIRST_ITERATION,
            torch.where(bad_tracking, VOEC_BAD_TRACKING, sol.error_code),
        ).to(torch.int32)
        valid = sol.valid & ~bad_tracking & ~first
        result = StepResult(
            pose=torch.where(valid, sol.pose, torch.zeros_like(sol.pose)),
            valid=valid,
            error_code=error_code,
            num_it=sol.num_it,
            num_it_final=sol.num_it_final,
            detected_feats=torch.stack(detected),
            stereo_matches=torch.stack(n_matches),
            tracked_feats_from_last_frame=n_tracked_total,
            tracked_feats_from_last_KF=n_tracked_kf,
            residuals=sol.residuals,
            track_mask=smask,
            inliers=sol.inliers,
            cost=sol.cost,
            obs_outlier=obs_outlier,
        )

        # ---- state shift with bounded keep-prev recovery --------------------
        # only bad tracking and a bad condition number keep the previous
        # frame, and at most max_recovery_frames times in a row
        recoverable = (bad_tracking | (
            (sol.error_code == VOEC_BAD_COND_NUMBER) & state.have_prev)) & ~first
        keep_prev = recoverable & (
            state.err_streak < cfg.general.max_recovery_frames)
        new_streak = torch.where(keep_prev, state.err_streak + 1,
                                 torch.zeros_like(state.err_streak))
        new_prev = _tree_map(lambda new, old: torch.where(keep_prev, old, new),
                             cur_view, state.prev)
        take_pose = valid & (ls.use_previous_pose_as_initial
                             and not ls.use_custom_initial_pose)
        new_state = EngineState(
            prev=new_prev,
            prev_pyr_l=state.prev_pyr_l,
            prev_pyr_r=state.prev_pyr_r,
            have_prev=torch.ones_like(state.have_prev),
            since_detect=torch.where(keep_prev, state.since_detect + 1,
                                     torch.zeros_like(state.since_detect)),
            last_match_id=last_id,
            last_kf_max_id=state.last_kf_max_id,
            last_pose=torch.where(take_pose, sol.delta_pose, state.last_pose),
            fast_th=torch.stack(new_fast_th),
            last_error=error_code,
            err_streak=new_streak,
            frame_idx=state.frame_idx + 1,
        )
        return new_state, result

    return step


class Engine:
    """Host-facing engine: owns config, camera, device and state.

    `device="cuda"` runs every stage on the GPU through the CUDA kernels and
    raises if CUDA is not available; nothing falls back to the CPU.
    """

    def __init__(self, cfg: RSOConfig, cam, rectify_maps=None, device="cpu"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda'): CUDA is not available")
        _check_slice(cfg, rectify_maps)
        if not isinstance(cam, StereoCamera):
            cam = StereoCamera.from_numpy(cam)
        self.cfg = cfg
        self.cam = cam.to(self.device)
        self.state: EngineState | None = None
        self._state_before_last: EngineState | None = None
        self._step_cache: dict[tuple, object] = {}

    def _get_step(self, h: int, w: int):
        if (h, w) not in self._step_cache:
            self._step_cache[(h, w)] = make_step(self.cfg, self.cam, h, w)
        return self._step_cache[(h, w)]

    def _image(self, img) -> torch.Tensor:
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(self.device)

    def process_frame(self, left_img, right_img,
                      repeat: bool = False) -> StepResult:
        """Run one frame through the pipeline; updates the state.

        repeat=True re-runs against the same previous frame as the last call
        (the reference's request.repeat semantics)."""
        left = self._image(left_img)
        right = self._image(right_img)
        h, w = left.shape[:2]
        if self.state is None:
            self.state = init_state(self.cfg, (h, w), self.device)
        if repeat and self._state_before_last is not None:
            self.state = self._state_before_last
        self._state_before_last = self.state
        self.state, result = self._get_step(h, w)(self.state, left, right)
        return result

    def process_chunk(self, left_imgs, right_imgs) -> StepResult:
        """N consecutive frames; results stacked along a leading frame axis.
        Same math and state evolution as N process_frame calls."""
        results = [self.process_frame(l, r)
                   for l, r in zip(left_imgs, right_imgs)]
        return StepResult(*(torch.stack(v) for v in zip(*results)))

    def reset(self):
        self.state = None
        self._state_before_last = None
