"""Subpixel refinement of tracked observations.

Counterpart of rso/frontend/refine.py `refine_positions`: each tracked
current-frame observation is aligned against the stored previous-frame 8x8
patch (template) by a few translation-only, inverse-compositional
Gauss-Newton iterations, vectorised over all keypoints.  The current image
is read once: a 16x16 window around each rounded start position, cut from
the edge-padded image by the detector's gather (`extract_patches_wide`);
every iteration then gathers its 9x9 bilinear support from that window.  The
reference cuts the 9x9 support with one-hot row/column matmuls, which pick
the same pixels: a TPU form that avoids gathers.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from rso_torch.frontend.detect import extract_patches_wide

_PAD = 8    # patch half-size: covers window reach (-3..+4) + shift (+-2.5) + 1
_S = 16


def _bilinear(cp: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor, n: int):
    """The n x n bilinear mix of [K, n+1, n+1] supports at fractions [K]."""
    fx, fy = fx[:, None, None], fy[:, None, None]
    return ((1 - fy) * (1 - fx) * cp[:, :n, :n]
            + (1 - fy) * fx * cp[:, :n, 1:n + 1]
            + fy * (1 - fx) * cp[:, 1:n + 1, :n]
            + fy * fx * cp[:, 1:n + 1, 1:n + 1])


def refine_positions(img: torch.Tensor, templates: torch.Tensor,
                     xy: torch.Tensor, valid: torch.Tensor, iters: int = 2,
                     max_shift: float = 2.0,
                     ssd_gate: bool = False) -> torch.Tensor:
    """Return refined [K,2] positions (invalid slots pass through).

    img [H,W] current octave image; templates [K,64] previous-frame 8x8
    patches; xy [K,2] current positions; valid [K].  `iters` GN iterations
    cost one window evaluation each; `ssd_gate` accepts a shift only if it
    cut the SSD to below 0.9 of the unshifted one.
    """
    H, W = img.shape
    K = xy.shape[0]
    img_p = F.pad(img[None, None], (_PAD,) * 4, mode="replicate")[0, 0]
    x = torch.clamp(xy[:, 0], 0.0, W - 1.0)
    y = torch.clamp(xy[:, 1], 0.0, H - 1.0)
    cx = torch.round(x)
    cy = torch.round(y)
    # [K,16,16] windows centred on the rounded start position (window index
    # _PAD,_PAD == image pixel (cy,cx))
    patches = extract_patches_wide(img_p, torch.stack([cx + _PAD, cy + _PAD], 1),
                                   _S, _PAD)
    r = torch.stack([x - cx, y - cy], dim=1)   # in [-0.5, 0.5]

    T = templates.reshape(K, 8, 8)
    # template gradients from the template itself (inverse compositional)
    gx = torch.zeros_like(T)
    gx[:, :, 1:7] = (T[:, :, 2:] - T[:, :, :-2]) * 0.5
    gy = torch.zeros_like(T)
    gy[:, 1:7, :] = (T[:, 2:, :] - T[:, :-2, :]) * 0.5
    Gxx = (gx * gx).sum((1, 2))
    Gxy = (gx * gy).sum((1, 2))
    Gyy = (gy * gy).sum((1, 2))
    det = Gxx * Gyy - Gxy * Gxy
    ok = det > 1e-6
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                      torch.zeros_like(det))

    kk = torch.arange(K, device=img.device)[:, None, None]
    nine = torch.arange(9, device=img.device)

    def window(d):
        # 8x8 bilinear window at in-patch offset r+d from the centre; all
        # taps stay inside the 16x16 patch for |r| <= 0.5, |d| <= max_shift
        q = r + d
        b = torch.clamp(torch.floor(q), -3, 2)
        f = q - b
        b = b.to(torch.int64)
        rows = (_PAD - 3 + b[:, 1:2] + nine)[:, :, None]
        cols = (_PAD - 3 + b[:, 0:1] + nine)[:, None, :]
        return _bilinear(patches[kk, rows, cols], f[:, 0], f[:, 1], 8)

    def ssd(d):
        return ((window(d) - T) ** 2).sum((1, 2))

    d = torch.zeros_like(xy)
    for _ in range(iters):
        e = window(d) - T
        bx = (gx * e).sum((1, 2))
        by = (gy * e).sum((1, 2))
        ddx = -(Gyy * bx - Gxy * by) * inv
        ddy = -(-Gxy * bx + Gxx * by) * inv
        d = torch.clamp(d + torch.stack([ddx, ddy], 1), -max_shift, max_shift)
    if ssd_gate:
        ok = ok & (ssd(d) < 0.9 * ssd(torch.zeros_like(d)))
    delta = torch.where(ok[:, None], d, torch.zeros_like(d))
    # delta is relative to the rounded centre; rebase onto the true start
    refined = torch.stack([cx, cy], dim=1) + r + delta
    return torch.where(valid[:, None], refined, xy)
