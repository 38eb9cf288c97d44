"""Pyramidal Lucas-Kanade optical flow, vectorised over keypoints.

Counterpart of rso/frontend/optical_flow.py, the engine's OPTICAL_FLOW
inter-frame mode (reference stage4_match_consecutive.cpp:333-431) and the
`detect_every` propagation: coarse-to-fine iterative LK with a fixed window
and iteration count, the coarsest level seeded by an exhaustive integer SAD
search, and a flow-guided association onto the current match set.

Each level pulls two patches per keypoint up front (the template around the
keypoint in the previous image, the search patch around the initial guess
in the current one) with the detector's gather; every iteration then
gathers its bilinear window from the search patch.  The reference cuts that
window with one-hot row/column matmuls (a TPU form that avoids gathers);
both pick the same pixels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from rso_torch.frontend.detect import extract_patches_wide
from rso_torch.frontend.refine import _bilinear


class FlowResult(NamedTuple):
    pos: torch.Tensor      # [K,2] tracked positions in the current image
    status: torch.Tensor   # [K] bool: converged && in-bounds
    err: torch.Tensor      # [K] mean abs residual at the solution


_LK_SLACK = 5    # in-patch drift allowance per level beyond the initial guess


def _pad_edge(img: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(img[None, None], (pad,) * 4, mode="replicate")[0, 0]


def _lk_level(prev_img, cur_img, pts_prev, guess, win: int, iters: int):
    """One pyramid level of iterative LK for all keypoints at once.

    pts_prev: [K,2] keypoint coords at this level; guess: [K,2] initial
    flow.  Returns (flow [K,2], residual [K], solvable [K]).  An iterate's
    integer window base may drift _LK_SLACK px from the initial guess; past
    that the window clamps to the patch edge and the residual grows.
    """
    r = win
    P = 2 * r + 1
    M = _LK_SLACK
    H, W = prev_img.shape
    K = pts_prev.shape[0]
    pad_t = r + 2                       # template reach: r+1 (grads) +1
    pad_c = r + 1 + M                   # search reach: r +1 (bilinear) +slack
    prev_p = _pad_edge(prev_img, pad_t)
    cur_p = _pad_edge(cur_img, pad_c)
    S_t = 2 * r + 4
    S_c = 2 * r + 2 + 2 * M

    x = torch.clamp(pts_prev[:, 0], 0.0, W - 1.001)
    y = torch.clamp(pts_prev[:, 1], 0.0, H - 1.001)
    bx = torch.floor(x)
    by = torch.floor(y)
    fx = x - bx
    fy = y - by
    # template patches: row/col 0 = image row by-(r+1) / col bx-(r+1)
    Tp = extract_patches_wide(prev_p, torch.stack([bx + pad_t, by + pad_t], 1),
                              S_t, r + 1)
    # search patches around the initial guess: row 0 = image row cby0-r-M
    cbx0 = torch.floor(torch.clamp(x + guess[:, 0], 0.0, W - 1.001))
    cby0 = torch.floor(torch.clamp(y + guess[:, 1], 0.0, H - 1.001))
    Cp = extract_patches_wide(cur_p, torch.stack([cbx0 + pad_c, cby0 + pad_c], 1),
                              S_c, r + M)

    w00 = ((1 - fy) * (1 - fx))[:, None, None]
    w01 = ((1 - fy) * fx)[:, None, None]
    w10 = (fy * (1 - fx))[:, None, None]
    w11 = (fy * fx)[:, None, None]

    def samp(oy, ox):
        # bilinear window grid at integer offset (oy,ox) from the centre
        i, j = 1 + oy, 1 + ox
        return (w00 * Tp[:, i:i + P, j:j + P]
                + w01 * Tp[:, i:i + P, j + 1:j + P + 1]
                + w10 * Tp[:, i + 1:i + P + 1, j:j + P]
                + w11 * Tp[:, i + 1:i + P + 1, j + 1:j + P + 1])

    T = samp(0, 0)
    # template gradients (standard LK uses prev-image gradients)
    Ix = (samp(0, 1) - samp(0, -1)) * 0.5
    Iy = (samp(1, 0) - samp(-1, 0)) * 0.5
    Gxx = (Ix * Ix).sum((1, 2))
    Gxy = (Ix * Iy).sum((1, 2))
    Gyy = (Iy * Iy).sum((1, 2))
    det = Gxx * Gyy - Gxy * Gxy
    ok = det > 1e-6
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))

    kk = torch.arange(K, device=prev_img.device)[:, None, None]
    taps = torch.arange(P + 1, device=prev_img.device)

    def cur_window(g):
        qx = torch.clamp(x + g[:, 0], 0.0, W - 1.001)
        qy = torch.clamp(y + g[:, 1], 0.0, H - 1.001)
        cbx = torch.floor(qx)
        cby = torch.floor(qy)
        dbx = torch.clamp(cbx - cbx0, -M, M).to(torch.int64)
        dby = torch.clamp(cby - cby0, -M, M).to(torch.int64)
        rows = (M + dby[:, None] + taps)[:, :, None]
        cols = (M + dbx[:, None] + taps)[:, None, :]
        return _bilinear(Cp[kk, rows, cols], qx - cbx, qy - cby, P)

    g = guess
    for _ in range(iters):
        e = cur_window(g) - T
        bx_ = (Ix * e).sum((1, 2))
        by_ = (Iy * e).sum((1, 2))
        dgx = -(Gyy * bx_ - Gxy * by_) * inv_det
        dgy = -(-Gxy * bx_ + Gxx * by_) * inv_det
        g = g + torch.stack([dgx, dgy], 1)
    err = (cur_window(g) - T).abs().mean((1, 2))
    return g, err, ok


def _coarse_sad_seed(prev_img, cur_img, pts, seed_range: int):
    """Integer flow seed at the coarsest level: the exhaustive 8x8-SAD
    argmin over +-seed_range px (the reference's tracking_SAD contract,
    tracking_SAD.cpp:73-125), first index on ties.  The images are padded by
    the window's full reach so that border keypoints keep a centred window.
    Every SAD is exact in f32 (64 terms, each a multiple of 1/4^octave below
    256), so any summation order gives the reference's seed."""
    Ms = seed_range
    S = 8 + 2 * Ms
    D = 2 * Ms + 1
    pad = Ms + 4
    ctr = pts + pad
    T = extract_patches_wide(_pad_edge(prev_img, pad), ctr, 8, 3)
    Sp = extract_patches_wide(_pad_edge(cur_img, pad), ctr, S, 3 + Ms)
    # every 8x8 window of each search patch: [K, D, D, 8, 8]
    windows = Sp.unfold(1, 8, 1).unfold(2, 8, 1)
    sad = (windows - T[:, None, None]).abs().sum((3, 4))
    idx = torch.argmin(sad.reshape(-1, D * D), dim=1)
    dy = torch.div(idx, D, rounding_mode="floor") - Ms
    dx = idx % D - Ms
    return torch.stack([dx, dy], dim=1).to(pts.dtype)


def lk_track(prev_pyr: list, cur_pyr: list, pts: torch.Tensor,
             valid: torch.Tensor, win: int = 10, iters: int = 10,
             max_err: float = 20.0, seed_range: int = 12) -> FlowResult:
    """Track pts [K,2] (octave-0 coords of the pyramids given) from prev to
    cur, coarse to fine.  The coarsest level starts from the SAD seed
    (seed_range=0 turns it off); each finer one from the doubled flow."""
    L = len(prev_pyr)
    flow = torch.zeros_like(pts)
    ok_all = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    err = torch.zeros(pts.shape[0], dtype=torch.float32, device=pts.device)
    for lvl in range(L - 1, -1, -1):
        pts_l = pts * (1.0 / (2 ** lvl))
        if lvl == L - 1 and seed_range > 0:
            flow = _coarse_sad_seed(prev_pyr[lvl], cur_pyr[lvl], pts_l,
                                    seed_range)
        flow, err, ok = _lk_level(prev_pyr[lvl], cur_pyr[lvl], pts_l, flow,
                                  win, iters)
        ok_all = ok_all & ok
        if lvl > 0:
            flow = flow * 2.0
    new_pos = pts + flow
    H, W = cur_pyr[0].shape
    inb = ((new_pos[:, 0] >= 1) & (new_pos[:, 0] < W - 1)
           & (new_pos[:, 1] >= 1) & (new_pos[:, 1] < H - 1))
    status = valid & ok_all & inb & (err <= max_err)
    return FlowResult(pos=new_pos, status=status, err=err)


def flow_guided_association(predicted: torch.Tensor, pred_ok: torch.Tensor,
                            cur_xy: torch.Tensor, cur_ok: torch.Tensor,
                            gate: float = 4.0):
    """prev-slot -> cur-slot association: the nearest current match inside
    a gate around the LK prediction.  Returns (cur_idx [K] int32, -1 where
    none; valid [K])."""
    d2 = ((predicted[:, None, :] - cur_xy[None, :, :]) ** 2).sum(-1)
    d2 = torch.where(pred_ok[:, None] & cur_ok[None, :], d2,
                     torch.full_like(d2, torch.inf))
    best = torch.argmin(d2, dim=1)
    bd = d2.gather(1, best[:, None])[:, 0]
    ok = torch.isfinite(bd) & (bd <= gate * gate)
    best = best.to(torch.int32)
    return torch.where(ok, best, torch.full_like(best, -1)), ok
