"""Stage 3: left<->right stereo matching (SAD method).

Counterpart of rso/frontend/stereo_match.py `match_left_right`: the fused
exact-SAD core (kernel 2, kernels/stereo_fused.py) gives each left slot its
best and second-best admissible right slot; the ratio test, the z-gate and
the one-to-one right arbitration follow as [K]-sized tensor ops.  Output is
left-slot aligned: slot l holds the right index matched to left feature l,
or -1.  The descriptor methods (DESC_BF, DESC_RBR) are ROADMAP Queue 1 #13.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from rso_torch.config import LeftRightMatchParams, StereoMatchMethod
from rso_torch.frontend.detect import Features
from rso_torch.kernels.stereo_fused import BIG, _f32, stereo_sad_fused_auto

_INT_MAX = 2**31 - 1


class StereoMatches(NamedTuple):
    ridx: torch.Tensor   # [K] int32: right index matched to left slot, -1 if none
    dist: torch.Tensor   # [K] f32 match distance
    valid: torch.Tensor  # [K] bool


def _arbitrate_right(cand_r: torch.Tensor, cand_d: torch.Tensor,
                     cand_ok: torch.Tensor, K_r: int,
                     keep_best: bool) -> torch.Tensor:
    """One-to-one right-feature arbitration; returns the surviving left mask.

    keep_best=True keeps, per right feature, the lowest-distance left (then
    the lowest slot); keep_best=False keeps the first left in slot order.
    """
    K_l = cand_r.shape[0]
    l_idx = torch.arange(K_l, dtype=torch.int64, device=cand_r.device)
    if keep_best:
        # (distance, index) as one key; distances are integral and small
        key = torch.clamp(cand_d, 0, 2**20).to(torch.int64) * K_l + l_idx
    else:
        key = l_idx
    key = torch.where(cand_ok, key, torch.full_like(key, _INT_MAX))
    claims = (cand_r.to(torch.int64)[:, None]
              == torch.arange(K_r, device=cand_r.device)[None, :]) & cand_ok[:, None]
    keymat = torch.where(claims, key[:, None], torch.full_like(key, _INT_MAX)[:, None])
    best_key = keymat.amin(dim=0)                                 # [K_r]
    safe_r = torch.clamp(cand_r.to(torch.int64), 0, K_r - 1)
    return cand_ok & (key == best_key[safe_r])


def match_left_right(left: Features, right: Features,
                     params: LeftRightMatchParams, img_w: int,
                     min_response: float,
                     fx_baseline: float | None = None) -> StereoMatches:
    """Stereo-match one octave's left/right feature sets.

    fx_baseline = fx * baseline (octave-scaled): when given, the winning
    match's disparity must lie inside the min_z/max_z depth window.
    """
    if params.match_method != StereoMatchMethod.SAD:
        raise NotImplementedError(
            f"match_method={params.match_method!r}: only SAD is ported "
            "(descriptor matching is ROADMAP Queue 1 #13)")
    K = left.xy.shape[0]
    xl = left.xy[:, 0]
    xr = right.xy[:, 0]
    ok_l = left.valid & (left.response >= _f32(min_response))
    ok_r = right.valid & (right.response >= _f32(min_response))
    best_r, best_d, second_d = stereo_sad_fused_auto(
        left.patch, right.patch, left.xy, right.xy, ok_l, ok_r,
        max_y_diff=float(max(params.max_y_diff, 0.0)),
        max_disp=img_w * 0.7, max_distance=float(params.sad_max_distance))

    cand_ok = best_d < BIG
    ratio = best_d / torch.clamp(second_d, min=_f32(1e-6))
    cand_ok &= (second_d >= BIG) | (ratio <= _f32(params.sad_max_ratio))

    # z-gate as a post-filter on the winning match's disparity
    if fx_baseline is not None:
        best_disp = xl - xr[torch.clamp(best_r.to(torch.int64), 0, K - 1)]
        min_disp_z = _f32(fx_baseline / params.max_z)
        max_disp_z = _f32(fx_baseline / max(params.min_z, 1e-6))
        cand_ok &= (best_disp >= min_disp_z) & (best_disp <= max_disp_z)

    survive = _arbitrate_right(best_r, best_d, cand_ok, K,
                               keep_best=params.enable_robust_1to1_match)
    ridx = torch.where(survive, best_r, torch.full_like(best_r, -1))
    dist = torch.where(survive, best_d, torch.zeros_like(best_d))
    return StereoMatches(ridx=ridx, dist=dist, valid=survive)
