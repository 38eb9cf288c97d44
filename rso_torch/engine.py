"""The odometry engine: EngineState + one per-frame step, on one device.

Counterpart of rso/engine.py (`init_state`, `make_step`, `Engine`):
grayscale, the optional rectification remap and the pyramid (stage 1),
detection with every detector and adaptive NMS (stage 2), stereo matching by
SAD or descriptors (stage 3), inter-frame tracking by SAD, DESC_WIN, DESC_BF
or OPTICAL_FLOW, the flat two-eye fundamental-matrix RANSAC, the optional
subpixel refine of the tracked observations, match-ID propagation, the
bad-tracking gate, stage-5 NMS, the two-phase robust pose solve (Cholesky or
eigh, with optional LM damping), error codes and the bounded keep-prev
recovery (`_tail`).  `tpu.detect_every > 1` LK-propagates the previous
frame's stereo pairs between detections (`_propagate`); `precomputed`
steps take external features or matches (the reference's
use_precomputed_data seam).  `tpu.use_fused_match` picks the fused SAD
kernels (the default) or the dense SAD matrices for stages 3 and 4.

`make_step` is the eager step: PyTorch on the state's device, with the six
CUDA kernels under it.  `Engine` runs it as the reference runs its jitted
step: one `rso_torch.graphs.CompiledStep` per (h, w, precomputed), which on
the GPU captures the step once and launches it as one CUDA graph on every
frame, through static buffers that the caller's states and results never
alias.  The state lives on the device between frames, and a frame is one
CUDA graph launch with no host read: the pose solver's GN loops are
conditional WHILE nodes and, with detect_every > 1, the choice between
detecting and propagating is a pair of IF nodes (`engine_branches`), as
the reference's lax.while_loop and lax.cond run on its device.  Every
solve backend runs so, eigh included (its eigensolver is the eigh6 kernel
on the GPU).  On the CPU the same object runs the eager step, which reads
the branch and the loops' flags on the host.  The entry points run on the
GPU unless the caller passes device="cpu", and raise where CUDA is
absent.

The step marks its stages for the stage clock
(rso_torch.metrics.profiler.STAGE_CLOCK; nothing while its marks are off):
`_stg1` at stage 1, `_stg2` at detection (`propagate` at detect_every's
propagation), `_stg3` at stereo matching, `_stg4` at tracking and again at
the ID propagation after RANSAC (OPTICAL_FLOW's tracker brackets its LK
call with `lk` and `_stg4`), `ransac` before the flat filter, `_stg5`
at the stage-4.1 gate (the pose solver adds `gn_block` and `_stg5` marks),
and `update` at the error codes, the result and the state shift.  Engine
opens PROFILER's spans `processNewImagePair` and `process_chunk` around
its entries, and `images_in` around the images' copies to the device.
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
    RSOConfig,
    StereoMatchMethod,
)
from rso_torch.frontend.detect import (
    Features,
    detect_features,
    extract_patches,
    octave_budget,
    octave_k_slots,
    update_fast_threshold,
)
from rso_torch.frontend.optical_flow import FlowResult, lk_track_eyes
from rso_torch.frontend.pyramid import (bilinear_remap, build_pyramid,
                                        to_grayscale)
from rso_torch.frontend.refine import refine_positions
from rso_torch.frontend.stereo_match import StereoMatches, match_left_right
from rso_torch.frontend.track import (TrackResult, track_interframe,
                                      track_optical_flow)
from rso_torch.geometry.stereo_camera import StereoCamera
from rso_torch.graphs import Branches, CompiledStep
from rso_torch.graphs import tree_map as _tree_map
from rso_torch.metrics.profiler import PROFILER, STAGE_CLOCK
from rso_torch.solver.ransac import ransac_fundamental
from rso_torch.solver.robust_gn import (
    HOST_READS,
    VOEC_BAD_COND_NUMBER,
    VOEC_BAD_TRACKING,
    VOEC_FIRST_ITERATION,
    VOEC_NONE,
    eager_blocks,
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
    prev_pyr_l: tuple             # prev-frame pyramids (OPTICAL_FLOW or
    prev_pyr_r: tuple             # detect_every > 1, else empty)
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


def detect_flag(cfg: RSOConfig, state: EngineState) -> torch.Tensor:
    """detect_every's choice as a device flag (the predicate of the
    reference's lax.cond, rso/engine.py:454): detect on the first frame,
    every detect_every-th frame, when too few stereo pairs are left to
    propagate, and after a recovery.  Per lane under vmap."""
    every = max(1, int(cfg.tpu.detect_every))
    prev_pairs = sum(oc.matches.valid.sum(dtype=torch.int32)
                     for oc in state.prev.octaves)
    return (~state.have_prev | (state.since_detect + 1 >= every)
            | (prev_pairs < cfg.tpu.propagate_min_matches)
            | (state.err_streak > 0))


def detects_this_frame(cfg: RSOConfig, state: EngineState) -> bool:
    """`detect_flag` read back to the host: one read where detect_every
    > 1; always True otherwise."""
    if max(1, int(cfg.tpu.detect_every)) == 1:
        return True
    HOST_READS["detect_every"] += 1
    return bool(detect_flag(cfg, state))


def lanes_detect(cfg: RSOConfig, states: EngineState):
    """The branch of a batched step (states with a leading lanes' axis):
    True where every lane detects, False where none does, MIXED where they
    differ; one host read where detect_every > 1."""
    if max(1, int(cfg.tpu.detect_every)) == 1:
        return True
    HOST_READS["detect_every"] += 1
    flags = torch.func.vmap(lambda st: detect_flag(cfg, st))(states).tolist()
    return flags[0] if len(set(flags)) == 1 else MIXED


# the branch of a step whose lanes differ: both branches run and each lane
# takes its own (the reference's lax.cond under vmap)
MIXED = "mixed"


def engine_branches(cfg: RSOConfig) -> Branches:
    """detect_every's branches of a step: (detect, propagate), read on the
    host by detects_this_frame, on the device as [detect, propagate]."""
    def flags(state):
        f = detect_flag(cfg, state)
        return torch.stack([f, ~f])

    return Branches(keys=(True, False),
                    read=lambda st: detects_this_frame(cfg, st), flags=flags)


def _keeps_pyramids(cfg: RSOConfig) -> bool:
    """Whether the state carries the previous frame's pyramids."""
    return (cfg.if_match.ifm_method == IFMatchMethod.OPTICAL_FLOW
            or cfg.tpu.detect_every > 1)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r}: CUDA is not available")
    return dev


def init_state(cfg: RSOConfig, img_hw: tuple | None = None,
               device="cuda") -> EngineState:
    """The state before the first frame.  The FAST threshold starts at the
    config's initial_FAST_threshold for every octave.  OPTICAL_FLOW and
    detect_every > 1 carry the previous pyramids, zero at first, and need
    img_hw."""
    device = _device(device)
    O = cfg.n_octaves
    Ks = octave_k_slots(cfg.detect.orb_nfeats, O, cfg.tpu.max_kps_per_octave,
                        cfg.tpu.octave_slot_decay)
    pyr_l = pyr_r = ()
    if _keeps_pyramids(cfg):
        if img_hw is None:
            raise ValueError("OPTICAL_FLOW / detect_every>1 modes need "
                             "img_hw for init_state")
        h, w = img_hw
        pyr_l, pyr_r = (tuple(torch.zeros((h >> o, w >> o), dtype=torch.float32,
                                          device=device) for o in range(O))
                        for _ in range(2))
    return EngineState(
        prev=FrameView(octaves=tuple(_empty_octave(k, device) for k in Ks)),
        prev_pyr_l=pyr_l,
        prev_pyr_r=pyr_r,
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


def state_from_numpy(tree, device="cuda") -> EngineState:
    """The reference's EngineState, every leaf passed through np.asarray, as
    this package's EngineState on `device` — the bridge that lets a test
    start the port from exactly the state the reference reached.  The
    reference's uint32 descriptor words become int32 with the same bits."""
    device = _device(device)

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


def _set_last(old: torch.Tensor, tgt: torch.Tensor, values: torch.Tensor):
    """(old.at[tgt].set(values, mode="drop"), the rows written), with the
    order of XLA's scatter on the CPU where targets repeat: the last write
    wins (an index_put_ on CUDA promises no order).  Targets outside
    [0, len(old)) are dropped.  Stereo matches are one-to-one on right slots
    in both arbitration modes, so the engine's own states never repeat a
    target; a state made by hand can."""
    rows = torch.arange(tgt.shape[0], device=tgt.device)
    slots = torch.arange(old.shape[0], device=tgt.device)
    writer = torch.where(tgt[:, None] == slots[None, :], rows[:, None],
                         torch.full_like(rows, -1)[:, None]).amax(0)
    written = writer >= 0
    new = torch.where(written[:, None], values[torch.clamp(writer, min=0)], old)
    return new, written


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
    step(state, left_img, right_img) -> (state', StepResult), run eagerly.
    Every step also takes `loop`, the runner of the pose solver's GN blocks
    (robust_gn.eager_blocks), and the image step `do_detect`, the branch
    of detect_every (None: detects_this_frame's host read; MIXED: both
    branches, each lane taking the one its `detect_flag` picks).

    rectify_maps: optional ((mlx, mly), (mrx, mry)) float32 [H,W] sample
        maps (rso_torch.io.calib.compute_rectify_maps), applied before the
        pyramid on the camera's device.
    precomputed: None for the full pipeline; "feats" for a step(state,
        octs) that takes per-octave (left, right) Features and skips stages
        1-2; "matches" for a step(state, octs, matches) that also takes the
        per-octave StereoMatches and skips stage 3.
    """
    O = cfg.n_octaves
    dev = cam.fx_l.device
    budgets = octave_budget(cfg.detect.orb_nfeats, O)
    Ks = octave_k_slots(cfg.detect.orb_nfeats, O, cfg.tpu.max_kps_per_octave,
                        cfg.tpu.octave_slot_decay)
    offs = np.cumsum([0] + Ks).tolist()
    flow = cfg.if_match.ifm_method == IFMatchMethod.OPTICAL_FLOW
    need_desc = (
        cfg.detect.detect_method in (DetectMethod.ORB, DetectMethod.FAST_ORB)
        or cfg.lr_match.match_method != StereoMatchMethod.SAD
        or cfg.if_match.ifm_method in (IFMatchMethod.DESC_BF,
                                       IFMatchMethod.DESC_WIN))
    if cfg.detect.detect_method == DetectMethod.KLT:
        min_response = cfg.detect.minimum_KLT_response
    elif cfg.detect.detect_method == DetectMethod.ORB:
        min_response = cfg.detect.minimum_ORB_response
    else:
        min_response = 0.0  # reference stage3:188-193 for FAST detectors

    if precomputed and flow:
        raise ValueError("precomputed-data injection requires a descriptor/"
                         "SAD tracking mode (no images for optical flow)")
    if precomputed and cfg.tpu.detect_every > 1:
        raise ValueError("precomputed-data injection cannot combine with "
                         "detect_every>1 (propagation needs the images)")
    detect_every = max(1, int(cfg.tpu.detect_every))
    if detect_every > 1 and (need_desc or flow):
        raise ValueError("detect_every>1 requires the SAD match/track "
                         "methods (descriptors are not re-extracted on "
                         "propagated frames; OPTICAL_FLOW already carries "
                         "its own LK stage)")

    maps = None
    if rectify_maps is not None:
        (mlx, mly), (mrx, mry) = rectify_maps
        maps = tuple(torch.as_tensor(m, dtype=torch.float32, device=dev)
                     for m in (mlx, mly, mrx, mry))
    use_fused = cfg.tpu.use_fused_match
    # the z-gate's octave-scaled fx*baseline, from the f32 camera entries
    fx_baseline = [float(cam.fx_l) * float(cam.baseline) / (2 ** o)
                   if cfg.lr_match.use_z_gate else None for o in range(O)]
    # per-octave fundamental-matrix filtering is off for the matrix trackers:
    # one flat filter runs over all octaves in _tail (flow keeps its own)
    ifm = dataclasses.replace(cfg.if_match, filter_fund_matrix=False)
    ls = cfg.least_squares
    tpu = cfg.tpu

    mark = STAGE_CLOCK.mark

    def _stage_1(left_img, right_img):
        mark("_stg1", dev)
        gl = to_grayscale(left_img)
        gr = to_grayscale(right_img)
        if maps is not None:
            gl = bilinear_remap(gl, maps[0], maps[1])
            gr = bilinear_remap(gr, maps[2], maps[3])
        return build_pyramid(gl, O), build_pyramid(gr, O)

    def _stage_2(state, pyr_l, pyr_r):
        mark("_stg2", dev)
        octs, new_fast_th, detected = [], [], []
        for o in range(O):
            th = state.fast_th[o]
            fl = detect_features(pyr_l[o], cfg.detect, Ks[o], th, need_desc,
                                 arc=tpu.fast_arc)
            fr = detect_features(pyr_r[o], cfg.detect, Ks[o], th, need_desc,
                                 arc=tpu.fast_arc)
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

    def _new_ids(k):
        return torch.full((k,), -1, dtype=torch.int32, device=dev)

    def _stage_3(octs):
        mark("_stg3", dev)
        cur_octs, n_matches = [], []
        for o in range(O):
            fl, fr = octs[o]
            m = match_left_right(fl, fr, cfg.lr_match, img_w >> o,
                                 min_response, fx_baseline=fx_baseline[o],
                                 use_fused=use_fused)
            cur_octs.append(OctaveData(left=fl, right=fr, matches=m,
                                       match_ids=_new_ids(Ks[o])))
            n_matches.append(m.valid.sum(dtype=torch.int32))
        return cur_octs, n_matches

    def _counts(octs):
        return [torch.stack([fl.valid.sum(dtype=torch.int32),
                             fr.valid.sum(dtype=torch.int32)])
                for fl, fr in octs]

    def step_feats(state: EngineState, octs, *, loop=eager_blocks):
        cur_octs, n_matches = _stage_3(octs)
        return _tail(state, None, None, cur_octs, n_matches, _counts(octs),
                     [state.fast_th[o] for o in range(O)], loop)

    def step_matches(state: EngineState, octs, matches, *, loop=eager_blocks):
        cur_octs = [OctaveData(left=octs[o][0], right=octs[o][1],
                               matches=matches[o], match_ids=_new_ids(Ks[o]))
                    for o in range(O)]
        n_matches = [m.valid.sum(dtype=torch.int32) for m in matches]
        return _tail(state, None, None, cur_octs, n_matches, _counts(octs),
                     [state.fast_th[o] for o in range(O)], loop)

    def _propagate(state, pyr_l, pyr_r):
        """Amortised detection: LK-propagate the previous frame's matched
        stereo pairs into the current pyramids, skipping stages 2-3.  Each
        pair is re-validated: LK convergence and bounds on both eyes, the
        epipolar row (|dy| <= max(max_y_diff, 1)), a positive disparity and
        the stereo SAD threshold on fresh 8x8 patches.  Stage 4 then
        associates prev -> cur through the usual windowed tracker."""
        mark("propagate", dev)
        cur_octs, n_matches, detected = [], [], []
        for o in range(O):
            p = state.prev.octaves[o]
            K = Ks[o]
            pair_ok = p.matches.valid
            p_ridx = torch.clamp(p.matches.ridx.to(torch.int64), min=0)
            pR_xy = p.right.xy[p_ridx]
            # both eyes in one LK call (one kernel launch on the GPU)
            lk = lk_track_eyes([state.prev_pyr_l[o:], state.prev_pyr_r[o:]],
                               [pyr_l[o:], pyr_r[o:]],
                               torch.stack([p.left.xy, pR_xy]),
                               torch.stack([p.left.valid, pair_ok]))
            fl, fr = (FlowResult(*(f[e] for f in lk)) for e in range(2))

            new_lxy = torch.where(fl.status[:, None], fl.pos, p.left.xy)
            lpatch = extract_patches(pyr_l[o], new_lxy)
            left = p.left._replace(
                xy=new_lxy, valid=p.left.valid & fl.status,
                patch=torch.where(fl.status[:, None], lpatch, p.left.patch))

            # tracked right positions go back to their slots; untracked
            # rows write out of range and are dropped
            upd = pair_ok & fr.status
            tgt = torch.where(upd, p_ridx, torch.full_like(p_ridx, K))
            new_rxy, moved = _set_last(p.right.xy, tgt, fr.pos)
            rpatch = extract_patches(pyr_r[o], new_rxy)
            right = p.right._replace(
                xy=new_rxy,
                patch=torch.where(moved[:, None], rpatch, p.right.patch))

            # per-frame pair re-validation (the stage-3 gates that still
            # apply without a fresh detect)
            epi_ok = ((fl.pos[:, 1] - fr.pos[:, 1]).abs()
                      <= max(cfg.lr_match.max_y_diff, 1.0))
            disp_ok = (fl.pos[:, 0] - fr.pos[:, 0]) > 0.0
            dist = (lpatch - rpatch[p_ridx]).abs().sum(1)
            dist_ok = dist <= cfg.lr_match.sad_max_distance
            m_ok = pair_ok & fl.status & fr.status & epi_ok & disp_ok & dist_ok
            matches = p.matches._replace(
                valid=m_ok, dist=torch.where(m_ok, dist,
                                             torch.full_like(dist, 1e9)))
            cur_octs.append(OctaveData(left=left, right=right, matches=matches,
                                       match_ids=_new_ids(K)))
            n_matches.append(m_ok.sum(dtype=torch.int32))
            detected.append(torch.stack([left.valid.sum(dtype=torch.int32),
                                         right.valid.sum(dtype=torch.int32)]))
        return cur_octs, n_matches, detected

    def step(state: EngineState, left_img, right_img, *, loop=eager_blocks,
             do_detect: bool | None = None):
        if do_detect is None:
            # the reference's lax.cond becomes a host branch: one read a frame
            do_detect = detects_this_frame(cfg, state)
        pyr_l, pyr_r = _stage_1(left_img, right_img)

        def detect_branch():
            octs, new_fast_th, detected = _stage_2(state, pyr_l, pyr_r)
            cur_octs, n_matches = _stage_3(octs)
            return cur_octs, n_matches, detected, new_fast_th

        def propagate_branch():
            cur_octs, n_matches, detected = _propagate(state, pyr_l, pyr_r)
            return (cur_octs, n_matches, detected,
                    [state.fast_th[o] for o in range(O)])

        if do_detect is MIXED:
            # lanes that differ: both branches, each lane its own
            do_detect = detect_flag(cfg, state)
            both = [tuple(b) for b in (detect_branch(), propagate_branch())]
            out = _tree_map(lambda d, p: torch.where(do_detect, d, p), *both)
        else:
            out = detect_branch() if do_detect else propagate_branch()
        return _tail(state, pyr_l, pyr_r, *map(list, out), loop,
                     did_detect=do_detect)

    def _tail(state, pyr_l, pyr_r, cur_octs, n_matches, detected, new_fast_th,
              loop, did_detect=True):
        mark("_stg4", dev)
        key = rrandom.fold_in(rrandom.PRNGKey(7, dev), state.frame_idx)

        # ---- stage 4: inter-frame tracking ----------------------------------
        tracks = []
        for o in range(O):
            p, c = state.prev.octaves[o], cur_octs[o]
            if flow:
                # pyramids sliced to [o:]: octave-o features live in octave-o
                # pixels, so their LK pyramid starts at level o
                trk = track_optical_flow(
                    state.prev_pyr_l[o:], state.prev_pyr_r[o:], pyr_l[o:],
                    pyr_r[o:], p.left, p.right, p.matches, c.left, c.right,
                    c.matches, cfg.if_match, rrandom.fold_in(key, o),
                    ransac_iters=tpu.ransac_iters,
                    ransac_threshold=tpu.ransac_threshold)
            else:
                trk = track_interframe(p.left, p.right, p.matches, c.left,
                                       c.right, c.matches, ifm, key=None,
                                       ransac_iters=tpu.ransac_iters,
                                       ransac_threshold=tpu.ransac_threshold,
                                       use_fused=use_fused)
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
            cL_xy = c.left.xy[safe_c]
            cR_xy = c.right.xy[c_ridx]
            if tpu.subpixel_track_refine and pyr_l is not None:
                # align the current observations to the previous frame's
                # patches; the templates are centred on the ROUNDED prev
                # coords, so the prev subpixel fraction is added back
                frac_l = p.left.xy - torch.round(p.left.xy)
                frac_r = pR_xy - torch.round(pR_xy)
                cL_xy = refine_positions(
                    pyr_l[o], p.left.patch, cL_xy, trk.valid,
                    iters=tpu.refine_iters,
                    ssd_gate=tpu.refine_ssd_gate) + frac_l
                cR_xy = refine_positions(
                    pyr_r[o], p.right.patch[p_ridx], cR_xy, trk.valid,
                    iters=tpu.refine_iters,
                    ssd_gate=tpu.refine_ssd_gate) + frac_r
            cur_obs_l.append(torch.cat([cL_xy, cR_xy], dim=1) * scale + shift)
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
        if cfg.if_match.filter_fund_matrix and not flow:
            mark("ransac", dev)
            keys = rrandom.split(rrandom.fold_in(key, 1000))
            res2 = ransac_fundamental(
                torch.stack([prev_obs[:, :2], prev_obs[:, 2:4]]),
                torch.stack([cur_obs[:, :2], cur_obs[:, 2:4]]),
                tmask, keys, n_iters=tpu.ransac_iters,
                threshold=tpu.ransac_threshold)
            both = res2.inliers[0] & res2.inliers[1]
            tmask = torch.where(res2.ok[0] & res2.ok[1], both, tmask)

        # ---- ID propagation with the post-filter tracks ----------------------
        mark("_stg4", dev)
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
        mark("_stg5", dev)
        bad_tracking = state.have_prev & (n_tracked_total < ls.bad_tracking_th)
        smask = tmask & _stage5_nms(prev_obs[:, :2], resp, tmask,
                                    cfg.detect.min_distance)
        init_pose = (state.last_pose if ls.use_previous_pose_as_initial
                     else torch.zeros_like(state.last_pose))
        sol = solve_pose(cam, prev_obs, cur_obs, smask, ls,
                         initial_pose=init_pose, obs_weight=obs_w, loop=loop)

        # per-CURRENT-slot outlier flags (dense one-hot routing, as above)
        outlier_prev = smask & ~sol.inliers
        obs_outlier = torch.cat([
            (claims_l[o] & outlier_prev[offs[o]:offs[o + 1], None]).any(dim=0)
            for o in range(O)])

        # ---- error codes & result -------------------------------------------
        mark("update", dev)
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
        keep = lambda new, old: torch.where(keep_prev, old, new)  # noqa: E731
        new_prev = _tree_map(keep, cur_view, state.prev)
        if _keeps_pyramids(cfg):
            new_pyr_l = tuple(map(keep, pyr_l, state.prev_pyr_l))
            new_pyr_r = tuple(map(keep, pyr_r, state.prev_pyr_r))
        else:
            new_pyr_l, new_pyr_r = state.prev_pyr_l, state.prev_pyr_r
        take_pose = valid & (ls.use_previous_pose_as_initial
                             and not ls.use_custom_initial_pose)
        # a kept-prev (recovery) frame leaves the OLD features in state, so
        # it never counts as a fresh detection whichever branch ran
        propagated = (~did_detect if isinstance(did_detect, torch.Tensor)
                      else not did_detect)
        new_since = torch.where(keep_prev | propagated,
                                state.since_detect + 1,
                                torch.zeros_like(state.since_detect))
        new_state = EngineState(
            prev=new_prev,
            prev_pyr_l=new_pyr_l,
            prev_pyr_r=new_pyr_r,
            have_prev=torch.ones_like(state.have_prev),
            since_detect=new_since,
            last_match_id=last_id,
            last_kf_max_id=state.last_kf_max_id,
            last_pose=torch.where(take_pose, sol.delta_pose, state.last_pose),
            fast_th=torch.stack(new_fast_th),
            last_error=error_code,
            err_streak=new_streak,
            frame_idx=state.frame_idx + 1,
        )
        return new_state, result

    if precomputed == "feats":
        return step_feats
    if precomputed == "matches":
        return step_matches
    if precomputed:
        raise ValueError(f"precomputed={precomputed!r}: one of None, "
                         "'feats', 'matches'")
    return step


class Engine:
    """Host-facing engine: owns config, camera, device and state.

    By default (`device="cuda"`) every stage runs on the GPU through the
    CUDA kernels, and the constructor raises if CUDA is not available;
    nothing falls back to the CPU.  `device="cpu"` runs the plain PyTorch
    twins of the kernels.  The API mirrors rso.engine.Engine (the
    reference's processNewImagePair -> process_frame, setThisFrameAsKF,
    resetIds, saveStateToFile -> rso_torch.io.checkpoint).
    """

    def __init__(self, cfg: RSOConfig, cam, rectify_maps=None, device="cuda"):
        self.device = _device(device)
        if not isinstance(cam, StereoCamera):
            cam = StereoCamera.from_numpy(cam)
        self.cfg = cfg
        self.cam = cam.to(self.device)
        # the maps go to the device once
        self.rectify_maps = None if rectify_maps is None else tuple(
            tuple(torch.as_tensor(m, dtype=torch.float32, device=self.device)
                  for m in eye) for eye in rectify_maps)
        self.state: EngineState | None = None
        self._state_before_last: EngineState | None = None
        self._step_cache: dict[tuple, object] = {}

    def _get_step(self, h: int, w: int,
                  precomputed: str | None = None) -> CompiledStep:
        """The compiled step of (h, w, precomputed), made at first use (the
        reference's jit cache, rso/engine.py:737-758): on the GPU one CUDA
        graph launch a frame, for every solve backend."""
        key = (h, w, precomputed)
        if key not in self._step_cache:
            cfg = self.cfg
            step = make_step(cfg, self.cam, h, w,
                             rectify_maps=self.rectify_maps,
                             precomputed=precomputed)
            branches = None
            if precomputed is None and cfg.tpu.detect_every > 1:
                branches = engine_branches(cfg)
            self._step_cache[key] = CompiledStep(
                step, branches=branches, capture=self.device.type == "cuda")
        return self._step_cache[key]

    def _image(self, img) -> torch.Tensor:
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(self.device)

    def process_frame(self, left_img, right_img,
                      repeat: bool = False) -> StepResult:
        """Run one frame through the pipeline; updates the state.

        repeat=True re-runs against the same previous frame as the last call
        (the reference's request.repeat semantics)."""
        with PROFILER.span("processNewImagePair"):
            with PROFILER.span("images_in"):
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
        """N consecutive frames; results stacked along a leading frame axis
        (the reference's lax.scan): the compiled step's graph launched N
        times with no read between them, the state kept in its buffers
        between frames and each result written into [N, ...] buffers.
        Same math and state evolution as N process_frame calls; a later
        `repeat` re-runs against the state
        before the chunk, as the reference's one-dispatch chunk leaves it."""
        with PROFILER.span("process_chunk"):
            with PROFILER.span("images_in"):
                lefts = [self._image(l) for l in left_imgs]
                rights = [self._image(r) for r in right_imgs]
            h, w = lefts[0].shape[:2]
            if self.state is None:
                self.state = init_state(self.cfg, (h, w), self.device)
            before = self.state
            self.state, results = self._get_step(h, w).chunk(
                self.state, lefts, rights)
            self._state_before_last = before
        return results

    # ---- dynamic threshold accessors (reference h:529-541) ----------------

    def get_fast_threshold(self) -> int:
        st = (self.state if self.state is not None
              else init_state(self.cfg, device=self.device))
        return int(st.fast_th[0])

    def set_fast_threshold(self, value: int):
        """Clamp to [fast_min_th, fast_max_th] and set every octave's FAST
        threshold (the dynamic threshold the SLAM layer adjusts)."""
        v = int(np.clip(value, self.cfg.detect.fast_min_th,
                        self.cfg.detect.fast_max_th))
        if self.state is None:
            self.state = init_state(self.cfg, device=self.device)
        self.state = self.state._replace(
            fast_th=torch.full_like(self.state.fast_th, v))

    def reset_fast_threshold(self):
        self.set_fast_threshold(self.cfg.detect.initial_FAST_threshold)

    def is_fast_th_min(self) -> bool:
        return self.get_fast_threshold() == self.cfg.detect.fast_min_th

    def is_fast_th_max(self) -> bool:
        return self.get_fast_threshold() == self.cfg.detect.fast_max_th

    def get_orb_threshold(self) -> float:
        return self.cfg.lr_match.orb_max_distance

    def set_orb_threshold(self, value: float):
        """Clamp to [orb_min_th, orb_max_th] and set the ORB matching
        distance of stereo matching and tracking; the steps are rebuilt."""
        v = float(np.clip(value, self.cfg.lr_match.orb_min_th,
                          self.cfg.lr_match.orb_max_th))
        self.cfg = self.cfg.replace(
            lr_match=dataclasses.replace(self.cfg.lr_match,
                                         orb_max_distance=v),
            if_match=dataclasses.replace(self.cfg.if_match,
                                         orb_max_distance=v),
        )
        self._step_cache.clear()

    def is_orb_th_min(self) -> bool:
        return self.cfg.lr_match.orb_max_distance <= self.cfg.lr_match.orb_min_th

    def is_orb_th_max(self) -> bool:
        return self.cfg.lr_match.orb_max_distance >= self.cfg.lr_match.orb_max_th

    def set_ids(self, ids):
        """Overwrite octave-0 match IDs (reference setIds, h:687-694: the
        SLAM layer re-keys matches after a loop closure)."""
        assert self.state is not None
        ids = np.asarray(ids, np.int32)
        oct0 = self.state.prev.octaves[0]
        K = oct0.match_ids.shape[0]
        new_ids = np.full((K,), -1, np.int32)
        new_ids[:len(ids)] = ids[:K]
        octs = ((oct0._replace(match_ids=torch.from_numpy(new_ids).to(
            self.device)),) + self.state.prev.octaves[1:])
        self.state = self.state._replace(
            prev=FrameView(octaves=octs),
            last_match_id=torch.clamp(self.state.last_match_id,
                                      min=int(ids.max()) + 1 if len(ids) else 0))

    def process_precomputed(self, feats_left, feats_right, matches=None,
                            img_hw=(376, 1241)) -> StepResult:
        """Run the pipeline on externally computed features (the reference's
        use_precomputed_data path, process_new_image_pair.cpp:131-162): skip
        stages 1-2, and stage 3 too when `matches` is given.

        feats_left/right: per-octave lists of Features or of dicts with
        xy [N,2], optional response [N], desc [N,8] uint32/int32 and patch
        [N,64].  matches: optional per-octave list of (left_idx, right_idx)
        int arrays.
        """
        if self.cfg.if_match.ifm_method == IFMatchMethod.OPTICAL_FLOW:
            raise ValueError("precomputed-data injection requires a "
                             "descriptor/SAD tracking mode")
        O = self.cfg.n_octaves
        Ks = octave_k_slots(self.cfg.detect.orb_nfeats, O,
                            self.cfg.tpu.max_kps_per_octave,
                            self.cfg.tpu.octave_slot_decay)
        h, w = img_hw
        if self.state is None:
            self.state = init_state(self.cfg, (h, w), self.device)
        dev = self.device

        def to_features(f, K) -> Features:
            if isinstance(f, Features):
                return Features(*(t.to(dev) for t in f))
            xy = np.asarray(f["xy"], np.float32)
            n = min(len(xy), K)
            out = {name: t.cpu().numpy() for name, t in
                   zip(Features._fields, _empty_features(K, "cpu"))}
            out["xy"][:n] = xy[:n]
            out["response"][:n] = np.asarray(
                f.get("response", np.ones(len(xy))), np.float32)[:n]
            out["valid"][:n] = True
            if "desc" in f:
                desc = np.asarray(f["desc"])
                out["desc"][:n] = desc.astype(np.uint32).view(np.int32)[:n]
            if "patch" in f:
                out["patch"][:n] = np.asarray(f["patch"], np.float32)[:n]
            return Features(*(torch.from_numpy(out[name]).to(dev)
                              for name in Features._fields))

        octs = tuple((to_features(feats_left[o], Ks[o]),
                      to_features(feats_right[o], Ks[o])) for o in range(O))
        if matches is None:
            step = self._get_step(h, w, precomputed="feats")
            self.state, result = step(self.state, octs)
            return result
        ms = []
        for o in range(O):
            li = np.asarray(matches[o][0], np.int64)
            ri = np.asarray(matches[o][1], np.int64)
            keep = (li < Ks[o]) & (ri < Ks[o])
            ridx = np.full((Ks[o],), -1, np.int32)
            valid = np.zeros((Ks[o],), bool)
            ridx[li[keep]] = ri[keep]      # a repeated slot: the last wins
            valid[li[keep]] = True
            ms.append(StereoMatches(
                ridx=torch.from_numpy(ridx).to(dev),
                dist=torch.zeros((Ks[o],), dtype=torch.float32, device=dev),
                valid=torch.from_numpy(valid).to(dev)))
        step = self._get_step(h, w, precomputed="matches")
        self.state, result = step(self.state, octs, tuple(ms))
        return result

    def set_this_frame_as_kf(self):
        """Record the max match ID as the keyframe watermark (reference
        setThisFrameAsKF, h:675-685)."""
        assert self.state is not None
        max_id = torch.stack([o.match_ids.amax() for o in
                              self.state.prev.octaves]).amax()
        self.state = self.state._replace(
            last_kf_max_id=torch.clamp(max_id, min=-1).to(torch.int32))

    def reset_ids(self):
        """Renumber current matches 0..N-1 and mark this frame as keyframe
        (reference resetIds + the m_reset block,
        process_new_image_pair.cpp:254-267)."""
        assert self.state is not None
        last = _int(0, self.device)
        new_octs = []
        for o in self.state.prev.octaves:
            valid = o.match_ids >= 0
            rank = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
            ids = torch.where(valid, rank + last, torch.full_like(rank, -1))
            last = last + valid.sum(dtype=torch.int32)
            new_octs.append(o._replace(match_ids=ids))
        self.state = self.state._replace(
            prev=FrameView(octaves=tuple(new_octs)),
            last_match_id=last,
            last_kf_max_id=last - 1,
        )

    def reset(self):
        self.state = None
        self._state_before_last = None
