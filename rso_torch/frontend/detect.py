"""Stage 2: dmFASTER detection — corner response, NMS, top-K, patches.

Counterpart of rso/frontend/detect.py, FASTER branch (`detect_features`):
the dense FAST-12 + Shi-Tomasi response (kernel 1, kernels/fast_detect.py),
windowed-max NMS, the border margin, exact top-K with the subpixel parabola,
and 8x8 SAD patches gathered at the rounded keypoints.

The other detectors (KLT, ORB, FAST_ORB), descriptors and adaptive NMS are
ROADMAP Queue 1 #13 and raise NotImplementedError here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from rso_torch.config import DetectMethod, DetectParams, NMSMethod
from rso_torch.kernels.fast_detect import corner_response_auto

# FAST circle (radius-3 Bresenham, the canonical 16 offsets) as (dx, dy)
_FAST_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


class Features(NamedTuple):
    """Fixed-capacity feature set for one image at one octave."""

    xy: torch.Tensor        # [K,2] f32 pixel coords (octave scale)
    response: torch.Tensor  # [K] f32
    valid: torch.Tensor     # [K] bool
    desc: torch.Tensor      # [K,8] int32: the reference's uint32 BRIEF words
    patch: torch.Tensor     # [K,64] f32 flattened 8x8 SAD patch


def _shift2d(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[y,x] = img[y+dy, x+dx], WRAPPING at the edges — the reference's
    `_shift2d` is a roll, and its border behaviour is what the port keeps."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))


def fast_corner_mask(img: torch.Tensor, threshold, arc: int = 12) -> torch.Tensor:
    """Dense FAST-N segment test: [H,W] bool, False on the 3-px border ring.

    A pixel is a corner if >= `arc` contiguous circle pixels are all brighter
    than center+t or all darker than center-t.  `threshold` may be a device
    scalar (the threshold servo's state)."""
    t = torch.as_tensor(threshold, device=img.device).to(img.dtype)
    hi = img + t
    lo = img - t
    bright = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    dark = torch.zeros_like(bright)
    for i, (dx, dy) in enumerate(_FAST_OFFSETS):
        n = _shift2d(img, dx, dy)
        bright |= (n > hi).to(torch.int32) << i
        dark |= (n < lo).to(torch.int32) << i

    def rotl16(b, s):
        s %= 16
        if s == 0:
            return b & 0xFFFF
        return ((b << s) | (b >> (16 - s))) & 0xFFFF

    def has_arc(b):
        # run-length doubling on the circular 16-bit word
        runs = {1: b}
        k = 1
        while 2 * k <= arc:
            runs[2 * k] = runs[k] & rotl16(runs[k], k)
            k *= 2
        need, acc, offset = arc, None, 0
        for p in sorted(runs, reverse=True):
            while need >= p:
                term = rotl16(runs[p], offset)
                acc = term if acc is None else (acc & term)
                offset += p
                need -= p
        return acc != 0

    corner = has_arc(bright) | has_arc(dark)
    H, W = img.shape
    border = torch.zeros_like(corner)
    border[3:H - 3, 3:W - 3] = True
    return corner & border


def _box_sum(img: torch.Tensor, r: int) -> torch.Tensor:
    """Sum over a (2r+1)^2 window, zero-padded, rows first then columns, in
    the reference's order."""
    H, W = img.shape
    s = 2 * r + 1
    p = F.pad(img, (0, 0, r, r))
    rows = sum(p[dy:dy + H, :] for dy in range(s))
    p = F.pad(rows, (r, r))
    return sum(p[:, dx:dx + W] for dx in range(s))


def shi_tomasi_response(img: torch.Tensor, win: int) -> torch.Tensor:
    """Dense min-eigenvalue of the (2*win+1)^2 box-averaged structure tensor
    of central-difference gradients."""
    gx = (_shift2d(img, 1, 0) - _shift2d(img, -1, 0)) * 0.5
    gy = (_shift2d(img, 0, 1) - _shift2d(img, 0, -1)) * 0.5
    # the window mean as a multiply by the float32 reciprocal: what the
    # reference's compiled `/ n` computes, and what PyTorch's CUDA division
    # by a scalar computes, so CPU, CUDA and kernel all round alike
    inv_n = float(np.float32(1.0 / (2 * win + 1) ** 2))
    gxx = _box_sum(gx * gx, win) * inv_n
    gyy = _box_sum(gy * gy, win) * inv_n
    gxy = _box_sum(gx * gy, win) * inv_n
    tr_half = 0.5 * (gxx + gyy)
    d = gxx - gyy
    det_term = torch.sqrt(torch.clamp(0.25 * (d * d) + gxy * gxy, min=0.0))
    return tr_half - det_term


def nms_grid(response: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep pixels that are the maximum of their (2r+1)^2 neighbourhood
    (-inf outside the image)."""
    r = max(int(radius), 1)
    wmax = F.max_pool2d(response[None, None], 2 * r + 1, stride=1,
                        padding=r)[0, 0]
    return response >= wmax


def select_topk(response: torch.Tensor, keep_mask: torch.Tensor, k: int,
                min_response: float = 0.0, subpixel: bool = True):
    """Top-K peaks of a masked response map -> (xy [K,2], resp [K], valid [K]).

    Exact top-K ordered by (value desc, flat index asc), the order of the
    reference's top-K: a stable descending sort.  With subpixel=True peaks
    are refined by a per-axis parabola on the response, clamped to +-0.5 px.
    """
    H, W = response.shape
    masked = torch.where(keep_mask, response,
                         torch.full_like(response, -torch.inf))
    vals, idx = torch.sort(masked.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    yi = idx // W
    xi = idx % W
    valid = torch.isfinite(vals) & (vals > min_response)
    xs = xi.to(torch.float32)
    ys = yi.to(torch.float32)
    if subpixel:
        def parab(vm, v0, vp):
            denom = vm - 2.0 * v0 + vp
            big = torch.abs(denom) > 1e-6
            off = torch.where(
                big, 0.5 * (vm - vp) / torch.where(big, denom,
                                                   torch.ones_like(denom)),
                torch.zeros_like(denom))
            return torch.clamp(off, -0.5, 0.5)

        xm = torch.clamp(xi - 1, 0, W - 1)
        xp = torch.clamp(xi + 1, 0, W - 1)
        ym = torch.clamp(yi - 1, 0, H - 1)
        yp = torch.clamp(yi + 1, 0, H - 1)

        def g(yy, xx):
            v = response[yy, xx]
            return torch.where(torch.isfinite(v), v, torch.zeros_like(v))

        v0 = g(yi, xi)
        zero = torch.zeros_like(v0)
        xs = xs + torch.where(valid, parab(g(yi, xm), v0, g(yi, xp)), zero)
        ys = ys + torch.where(valid, parab(g(ym, xi), v0, g(yp, xi)), zero)
    xy = torch.stack([xs, ys], dim=-1)
    return xy, torch.where(valid, vals, torch.zeros_like(vals)), valid


def extract_patches(img: torch.Tensor, xy: torch.Tensor, size: int = 8,
                    offset: int = 3) -> torch.Tensor:
    """size x size patches at the rounded keypoints -> [K, size*size]; the
    window (x-3..x+4, y-3..y+4) is clamped into the image as one unit."""
    H, W = img.shape
    x0 = torch.clamp(torch.round(xy[:, 0]).to(torch.int64) - offset, 0, W - size)
    y0 = torch.clamp(torch.round(xy[:, 1]).to(torch.int64) - offset, 0, H - size)
    r = torch.arange(size, device=img.device)
    rows = (y0[:, None] + r[None, :])[:, :, None]
    cols = (x0[:, None] + r[None, :])[:, None, :]
    return img[rows, cols].reshape(xy.shape[0], size * size)


def octave_budget(orb_nfeats: int, n_octaves: int) -> list[int]:
    """Per-octave target feature counts (reference stage2_detect.cpp:405-407):
    k0 = nfeats * 2*O / (2^O - 1), k_o = k0 / 2^o."""
    if n_octaves == 1:
        return [orb_nfeats]
    k0 = int(orb_nfeats * (2 * n_octaves) / (2 ** n_octaves - 1))
    return [max(1, int(round(k0 / 2 ** o))) for o in range(n_octaves)]


def octave_k_slots(orb_nfeats: int, n_octaves: int, k_max: int,
                   decay: bool = True) -> list[int]:
    """Per-octave slot capacities: the smallest multiple of 128 covering the
    octave budget, capped at k_max (uniform k_max without decay)."""
    if not decay:
        return [k_max] * n_octaves
    return [min(k_max, max(128, -(-b // 128) * 128))
            for b in octave_budget(orb_nfeats, n_octaves)]


def detect_features(img: torch.Tensor, params: DetectParams, k_slots: int,
                    fast_threshold, need_desc: bool, arc: int = 12) -> Features:
    """Detect up to k_slots dmFASTER features on one octave image."""
    if params.detect_method != DetectMethod.FASTER:
        raise NotImplementedError(
            f"detect_method={params.detect_method!r}: only FASTER is ported "
            "(KLT/ORB/FAST_ORB are ROADMAP Queue 1 #13)")
    if need_desc:
        raise NotImplementedError(
            "descriptors are ROADMAP Queue 1 #13 (FAST_ORB / DESC_* modes)")
    if params.non_maximal_suppression and params.nmsMethod == NMSMethod.ADAPTIVE:
        raise NotImplementedError(
            "adaptive NMS is ROADMAP Queue 1 #13 (adaptive_nms_select)")
    H, W = img.shape
    resp = corner_response_auto(img, fast_threshold, arc=arc,
                                win=params.KLT_win)
    corner = resp > -torch.inf
    if params.non_maximal_suppression:
        keep = nms_grid(resp, params.min_distance) & corner
    else:
        keep = corner

    # border margin: SAD patches need 4 px, the response window KLT_win + 1
    margin = max(4, params.KLT_win + 1)
    inb = torch.zeros_like(keep)
    inb[margin:H - margin, margin:W - margin] = True
    xy, resp_k, valid = select_topk(resp, keep & inb, k_slots,
                                    params.minimum_KLT_response)
    xy = torch.where(valid[:, None], xy, torch.zeros_like(xy))
    patch = extract_patches(img, xy)
    return Features(
        xy=xy, response=resp_k, valid=valid,
        desc=torch.zeros((k_slots, 8), dtype=torch.int32, device=img.device),
        patch=torch.where(valid[:, None], patch, torch.zeros_like(patch)))


def update_fast_threshold(threshold: torch.Tensor, n_feats: torch.Tensor,
                          img_area: int, params: DetectParams) -> torch.Tensor:
    """The FAST threshold servo (reference stage2_detect.cpp:537-550): +-1
    steps toward target_feats_per_pixel, clamped to [1, inf)."""
    density = n_feats.to(torch.float32) / float(img_area)
    lo = density < 0.8 * params.target_feats_per_pixel
    hi = density > 1.2 * params.target_feats_per_pixel
    return torch.where(lo, torch.clamp(threshold - 1, min=1),
                       torch.where(hi, threshold + 1, threshold))
