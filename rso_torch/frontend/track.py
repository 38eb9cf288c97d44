"""Stage 4: inter-frame tracking of stereo matches (ifmSAD).

Counterpart of rso/frontend/track.py `track_interframe`: the fused both-eye
exact-SAD core (kernel 3, kernels/stereo_fused.py) picks, per previous slot,
the admissible current slot inside the search window; one-to-one
arbitration keeps the best previous slot per current slot, and an optional
fundamental-matrix RANSAC filter on both eyes follows.  Output is
prev-slot aligned.  The descriptor and optical-flow methods are ROADMAP
Queue 1 #13 and #14.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from rso_torch import random as rrandom
from rso_torch.config import IFMatchMethod, InterFrameMatchParams
from rso_torch.frontend.detect import Features
from rso_torch.frontend.stereo_match import StereoMatches, _arbitrate_right
from rso_torch.kernels.stereo_fused import BIG, track_sad_fused_auto
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
                     ransac_threshold: float = 1.0) -> TrackResult:
    if params.ifm_method != IFMatchMethod.SAD:
        raise NotImplementedError(
            f"ifm_method={params.ifm_method!r}: only SAD is ported (DESC_* "
            "is ROADMAP Queue 1 #13, OPTICAL_FLOW Queue 1 #14)")
    K = prev_matches.ridx.shape[0]
    pR_xy, pR_patch, _ = _gather_right(prev_right, prev_matches.ridx)
    cR_xy, cR_patch, _ = _gather_right(cur_right, cur_matches.ridx)
    best_c, best_d = track_sad_fused_auto(
        prev_left.patch, cur_left.patch, pR_patch, cR_patch,
        prev_left.xy, cur_left.xy, pR_xy[:, 0].contiguous(),
        cR_xy[:, 0].contiguous(), prev_matches.valid, cur_matches.valid,
        win_row=float(params.ifm_win_w), win_col=float(params.ifm_win_h),
        sad_max=float(params.sad_max_distance))
    survive = _arbitrate_right(best_c, best_d, best_d < BIG, K,
                               keep_best=True)
    return _finish(prev_left, pR_xy, cur_left, cR_xy, best_c, survive,
                   params, key, ransac_iters, ransac_threshold)


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
