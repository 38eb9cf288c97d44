"""Stage 4: inter-frame tracking of stereo matches.

Counterpart of rso/frontend/track.py `track_interframe`: a (prev-left-slot x
cur-left-slot) cost with

  ifmSAD     -> SAD(prevL, curL) + SAD(prevR, curR), each side gated by
                sad_max_distance: the fused kernel 3 (kernels/stereo_fused.py)
                with `use_fused`, else two dense SAD matrices (kernel 6)
  ifmDescWin -> Hamming(prevL desc, curL desc) (kernel 5; the reference too
                uses only the left descriptor)
  ifmDescBF  -> Hamming L-L and R-R over the whole image; both sides must pick
                the same current slot, each within orb_max_distance

inside the search window (|dy| <= win_w, per-eye |dx| <= win_h) for SAD and
DESC_WIN; one-to-one arbitration keeps the best previous slot per current
slot, and an optional fundamental-matrix RANSAC filter on both eyes follows.
Output is prev-slot aligned.  OPTICAL_FLOW runs through `track_optical_flow`
(it needs the pyramids, which `track_interframe` does not take).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from rso_torch import random as rrandom
from rso_torch.config import IFMatchMethod, InterFrameMatchParams
from rso_torch.frontend.detect import Features
from rso_torch.frontend.optical_flow import (FlowResult,
                                             flow_guided_association,
                                             lk_track_eyes)
from rso_torch.frontend.stereo_match import StereoMatches, _arbitrate_right
from rso_torch.kernels.distance import hamming_matrix_auto, sad_matrix_auto
from rso_torch.kernels.stereo_fused import (BIG, _best_second, _f32,
                                           track_sad_fused_auto)
from rso_torch.metrics.profiler import STAGE_CLOCK
from rso_torch.solver.ransac import ransac_fundamental


class TrackResult(NamedTuple):
    cur_idx: torch.Tensor    # [K] int32: cur left slot tracked from prev slot p, -1
    valid: torch.Tensor      # [K] bool
    n_tracked: torch.Tensor  # int32


def _gather_right(feats_r: Features, ridx: torch.Tensor):
    """Right-feature data aligned to left slots via the match index."""
    safe = torch.clamp(ridx.to(torch.int64), min=0)
    return feats_r.xy[safe], feats_r.patch[safe], feats_r.desc[safe]


def track_interframe(prev_left: Features, prev_right: Features,
                     prev_matches: StereoMatches, cur_left: Features,
                     cur_right: Features, cur_matches: StereoMatches,
                     params: InterFrameMatchParams, key: torch.Tensor,
                     ransac_iters: int = 64,
                     ransac_threshold: float = 1.0,
                     use_fused: bool = True) -> TrackResult:
    method = params.ifm_method
    if method not in (IFMatchMethod.SAD, IFMatchMethod.DESC_WIN,
                      IFMatchMethod.DESC_BF):
        raise NotImplementedError(
            "ifmOpticalFlow: use track_optical_flow (needs image pyramids)")
    K = prev_matches.ridx.shape[0]
    p_ok, c_ok = prev_matches.valid, cur_matches.valid
    pR_xy, pR_patch, pR_desc = _gather_right(prev_right, prev_matches.ridx)
    cR_xy, cR_patch, cR_desc = _gather_right(cur_right, cur_matches.ridx)

    def finish(best_c, survive):
        return _finish(prev_left, pR_xy, cur_left, cR_xy, best_c, survive,
                       params, key, ransac_iters, ransac_threshold)

    if method == IFMatchMethod.SAD and use_fused:
        best_c, best_d = track_sad_fused_auto(
            prev_left.patch, cur_left.patch, pR_patch, cR_patch,
            prev_left.xy, cur_left.xy, pR_xy[:, 0].contiguous(),
            cR_xy[:, 0].contiguous(), p_ok, c_ok,
            win_row=float(params.ifm_win_w), win_col=float(params.ifm_win_h),
            sad_max=float(params.sad_max_distance))
        return finish(best_c, _arbitrate_right(best_c, best_d, best_d < BIG,
                                               K, keep_best=True))

    pair_ok = p_ok[:, None] & c_ok[None, :]
    if method == IFMatchMethod.DESC_BF:
        # both sides must independently pick the same cur slot, each within
        # orb_max_distance (no window: brute force over the image)
        big = torch.full((K, K), BIG, device=p_ok.device)
        best_l, d_l, _ = _best_second(torch.where(
            pair_ok, hamming_matrix_auto(prev_left.desc, cur_left.desc), big))
        best_r, d_r, _ = _best_second(torch.where(
            pair_ok, hamming_matrix_auto(pR_desc, cR_desc), big))
        max_d = _f32(params.orb_max_distance)
        cand_ok = (best_l == best_r) & (d_l <= max_d) & (d_r <= max_d) & p_ok
        return finish(best_l, _arbitrate_right(best_l, d_l + d_r, cand_ok, K,
                                               keep_best=True))

    if method == IFMatchMethod.SAD:
        sad_l = sad_matrix_auto(prev_left.patch, cur_left.patch)
        sad_r = sad_matrix_auto(pR_patch, cR_patch)
        sad_max = _f32(params.sad_max_distance)
        pair_ok = pair_ok & (sad_l <= sad_max) & (sad_r <= sad_max)
        cost = sad_l + sad_r
    else:   # DESC_WIN
        cost = hamming_matrix_auto(prev_left.desc, cur_left.desc)
    # row window (WIN_W) on y and per-eye column windows (WIN_H) on x
    win_row, win_col = _f32(params.ifm_win_w), _f32(params.ifm_win_h)
    dy = torch.abs(prev_left.xy[:, 1][:, None] - cur_left.xy[:, 1][None, :])
    dxl = torch.abs(prev_left.xy[:, 0][:, None] - cur_left.xy[:, 0][None, :])
    dxr = torch.abs(pR_xy[:, 0][:, None] - cR_xy[:, 0][None, :])
    pair_ok = pair_ok & (dy <= win_row) & (dxl <= win_col) & (dxr <= win_col)
    best_c, best_d, _ = _best_second(
        torch.where(pair_ok, cost, torch.full_like(cost, BIG)))
    return finish(best_c, _arbitrate_right(best_c, best_d, best_d < BIG, K,
                                           keep_best=True))


def _finish(prev_left, pR_xy, cur_left, cR_xy, best_c, survive, params, key,
            ransac_iters, ransac_threshold) -> TrackResult:
    """Fundamental-matrix filtering on both eyes + final packing."""
    if params.filter_fund_matrix:
        safe_c = torch.clamp(best_c.to(torch.int64), min=0)
        k1, k2 = rrandom.split(key)
        res2 = ransac_fundamental(
            torch.stack([prev_left.xy, pR_xy]),
            torch.stack([cur_left.xy[safe_c], cR_xy[safe_c]]),
            survive, torch.stack([k1, k2]), n_iters=ransac_iters,
            threshold=ransac_threshold)
        # if either model is degenerate, pass through (reference :256-259)
        both = res2.inliers[0] & res2.inliers[1]
        survive = torch.where(res2.ok[0] & res2.ok[1], both, survive)
    cur_idx = torch.where(survive, best_c, torch.full_like(best_c, -1))
    return TrackResult(cur_idx=cur_idx, valid=survive,
                       n_tracked=survive.sum(dtype=torch.int32))


def track_optical_flow(prev_pyr_l: list, prev_pyr_r: list, cur_pyr_l: list,
                       cur_pyr_r: list, prev_left: Features,
                       prev_right: Features, prev_matches: StereoMatches,
                       cur_left: Features, cur_right: Features,
                       cur_matches: StereoMatches,
                       params: InterFrameMatchParams, key: torch.Tensor,
                       ransac_iters: int = 64, ransac_threshold: float = 1.0,
                       lk_win: int = 10, lk_iters: int = 10,
                       gate: float = 4.0) -> TrackResult:
    """ifmOpticalFlow (reference stage4_match_consecutive.cpp:333-431):
    pyramidal LK on both eyes, the 1.5 px epipolar consistency of the
    tracked pair (:397), flow-guided association onto the current match set
    and the fundamental-matrix filter."""
    p_ok = prev_matches.valid
    pR_xy, _, _ = _gather_right(prev_right, prev_matches.ridx)
    cR_xy, _, _ = _gather_right(cur_right, cur_matches.ridx)
    # both eyes in one LK call (one kernel launch on the GPU), between the
    # stage clock's `lk` mark and the mark back to `_stg4`
    STAGE_CLOCK.mark("lk", p_ok.device)
    lk = lk_track_eyes([prev_pyr_l, prev_pyr_r], [cur_pyr_l, cur_pyr_r],
                       torch.stack([prev_left.xy, pR_xy]),
                       torch.stack([p_ok, p_ok]), win=lk_win, iters=lk_iters)
    STAGE_CLOCK.mark("_stg4", p_ok.device)
    fl, fr = (FlowResult(*(f[e] for f in lk)) for e in range(2))
    epi_ok = (fl.pos[:, 1] - fr.pos[:, 1]).abs() <= 1.5
    pred_ok = fl.status & fr.status & epi_ok
    cur_idx, ok = flow_guided_association(fl.pos, pred_ok, cur_left.xy,
                                          cur_matches.valid, gate=gate)
    best_c = torch.where(ok, cur_idx, torch.zeros_like(cur_idx))
    return _finish(prev_left, pR_xy, cur_left, cR_xy, best_c, ok, params, key,
                   ransac_iters, ransac_threshold)
