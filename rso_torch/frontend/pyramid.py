"""Stage 1: grayscale, rectification remap and image pyramid, on the device.

Counterpart of rso/frontend/pyramid.py.
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


def bilinear_remap(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """Sample img [H,W] f32 at float coords (map_x, map_y), bilinearly; 0
    where the map leaves the image (cv::remap's BORDER_CONSTANT).  The
    device half of rectification: the maps come from
    rso_torch.io.calib.compute_rectify_maps."""
    H, W = img.shape
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    # float -> int truncates toward zero, as XLA's convert does
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    top = img[y0i, x0i] * (1 - fx) + img[y0i, x1i] * fx
    bot = img[y1i, x0i] * (1 - fx) + img[y1i, x1i] * fx
    out = top * (1 - fy) + bot * fy
    valid = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    return torch.where(valid, out, torch.zeros_like(out))


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
