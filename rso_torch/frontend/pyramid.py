"""Stage 1: grayscale and image pyramid, on the device.

Counterpart of rso/frontend/pyramid.py.  `bilinear_remap` (rectification)
is not ported yet (ROADMAP Queue 1 #12).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """[H,W] or [H,W,3] uint8/float -> [H,W] float32 grayscale (0..255)."""
    img = img.to(torch.float32)
    if img.ndim == 3:
        img = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return img


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean, dropping an odd last row/column.  Exact for pyramid images:
    every value is a multiple of 1/4^octave below 256."""
    return F.avg_pool2d(img[None, None], 2, ceil_mode=False)[0, 0]


def build_pyramid(img: torch.Tensor, n_octaves: int) -> list[torch.Tensor]:
    """[img, half, quarter, ...] — octave o scaled by 2^-o."""
    out = [img]
    for _ in range(1, n_octaves):
        out.append(downsample2x(out[-1]))
    return out
