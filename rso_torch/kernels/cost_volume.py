"""Windowed SAD search: the reference's tracking_SAD as a batched op.

Counterpart of rso/kernels/cost_volume.py `windowed_sad_search`: each of K
8x8 templates is searched exhaustively over the (2*win_y+1)x(2*win_x+1)
candidate centers around its own center, and the best center and its SAD
come back.  In rso it is plain XLA (a region pull, an unfold and a sum),
not a Pallas kernel, so it has no CUDA kernel here: it is written in plain
PyTorch and runs on whatever device its tensors are on.

The rules it keeps from the reference: the whole window clamped in range
(its top-left corner at round(center) - 3 - win, clamped to [0, W - SX]);
`torch.round`, half to even like `jnp.round`; the first minimum in row
order (`torch.argmin`, like `jnp.argmin`); and float32's max as the SAD of
a template that is not valid.  On u8-valued images every SAD is an exact
integer in float32, so the result is exact whatever the summation order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class WindowedSearchResult(NamedTuple):
    best_xy: torch.Tensor   # [K,2] f32 best match center
    best_sad: torch.Tensor  # [K] f32 min SAD
    valid: torch.Tensor     # [K] bool


def windowed_sad_search(
    img: torch.Tensor,          # [H,W] f32 search image
    templates: torch.Tensor,    # [K,64] f32 8x8 template patches
    centers: torch.Tensor,      # [K,2] f32 search centers (x,y)
    win_x: int,
    win_y: int,
    valid: torch.Tensor | None = None,
) -> WindowedSearchResult:
    """Exhaustive min-SAD search of each template over its window: a gather
    of each template's region, every 8x8 window of it by `unfold`, their
    SADs and the argmin."""
    H, W = img.shape
    K = templates.shape[0]
    dev = img.device
    if valid is None:
        valid = torch.ones((K,), dtype=torch.bool, device=dev)
    SX, SY = 2 * win_x + 8, 2 * win_y + 8
    x0 = torch.clamp(torch.round(centers[:, 0]).to(torch.int32) - 3 - win_x,
                     0, W - SX)
    y0 = torch.clamp(torch.round(centers[:, 1]).to(torch.int32) - 3 - win_y,
                     0, H - SY)
    rows = y0[:, None] + torch.arange(SY, dtype=torch.int32, device=dev)
    cols = x0[:, None] + torch.arange(SX, dtype=torch.int32, device=dev)
    region = img[rows.long()[:, :, None], cols.long()[:, None, :]]  # [K,SY,SX]
    windows = F.unfold(region[:, None], kernel_size=8)   # [K,64,DY*DX]
    sad = (windows - templates.reshape(K, 64, 1)).abs().sum(dim=1)
    DX = 2 * win_x + 1
    idx = torch.argmin(sad, dim=1)
    dy = (idx // DX).to(torch.int32)
    dx = (idx % DX).to(torch.int32)
    best_xy = torch.stack([(x0 + dx + 3).to(torch.float32),
                           (y0 + dy + 3).to(torch.float32)], dim=1)
    best_sad = torch.gather(sad, 1, idx[:, None])[:, 0]
    best_sad = torch.where(valid, best_sad,
                           torch.tensor(torch.finfo(torch.float32).max,
                                        device=dev))
    return WindowedSearchResult(best_xy=best_xy, best_sad=best_sad,
                                valid=valid)
