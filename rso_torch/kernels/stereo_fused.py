"""Kernels 2 and 3: fused exact-SAD cores of stereo matching and tracking.

Replace rso/kernels/stereo_fused.py `stereo_sad_fused` and `track_sad_fused`
(see the header of csrc/stereo_fused.cu for the H100 bound and the design).
The `*_torch` twins compute the same masked all-pairs SAD as dense [K,K]
planes.  Both kernels evaluate the geometric and validity mask first and
form the SAD only of the pairs it admits (a row with none gives index 0 and
1e9, as the twin's argmin over a row of 1e9).  Every SAD is an exact f32
sum, so kernel and twin agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from rso_torch.kernels import _lib

BIG = 1e9


def _f32(v: float) -> float:
    """The float32 value a threshold takes inside the kernels (the reference
    compares f32 arrays with weakly typed Python floats, i.e. in f32)."""
    return float(np.float32(v))


def _sad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[Ka,P] x [Kb,P] -> [Ka,Kb] exact sum of absolute differences."""
    return torch.abs(a[:, None, :] - b[None, :, :]).sum(-1)


def _best_second(D: torch.Tensor):
    best_r = torch.argmin(D, dim=1)                    # first index on ties
    best_d = torch.gather(D, 1, best_r[:, None])[:, 0]
    lanes = torch.arange(D.shape[1], device=D.device)
    second = torch.where(lanes[None, :] == best_r[:, None],
                         torch.full_like(D, BIG), D).amin(dim=1)
    return best_r.to(torch.int32), best_d, second


def stereo_sad_fused_torch(patches_l, patches_r, xy_l, xy_r, ok_l, ok_r,
                           max_y_diff: float, max_disp: float,
                           max_distance: float):
    """Returns (best_r [K] int32, best_d [K] f32, second_d [K] f32)."""
    acc = _sad(patches_l.float(), patches_r.float())
    dy = torch.abs(torch.round(xy_l[:, 1])[:, None]
                   - torch.round(xy_r[:, 1])[None, :])
    disp = xy_l[:, 0][:, None] - xy_r[:, 0][None, :]
    ok = (ok_l[:, None] & ok_r[None, :] & (dy <= _f32(max_y_diff))
          & (disp >= 1.0) & (disp <= _f32(max_disp))
          & (acc <= _f32(max_distance)))
    return _best_second(torch.where(ok, acc, torch.full_like(acc, BIG)))


def track_sad_fused_torch(p_left_patch, c_left_patch, p_right_patch,
                          c_right_patch, p_left_xy, c_left_xy, p_right_x,
                          c_right_x, ok_p, ok_c, win_row: float,
                          win_col: float, sad_max: float):
    """Returns (best_c [K] int32, best_d [K] f32)."""
    acc_l = _sad(p_left_patch.float(), c_left_patch.float())
    acc_r = _sad(p_right_patch.float(), c_right_patch.float())
    dy = torch.abs(p_left_xy[:, 1][:, None] - c_left_xy[:, 1][None, :])
    dxl = torch.abs(p_left_xy[:, 0][:, None] - c_left_xy[:, 0][None, :])
    dxr = torch.abs(p_right_x[:, None] - c_right_x[None, :])
    win_row, win_col, sad_max = _f32(win_row), _f32(win_col), _f32(sad_max)
    ok = (ok_p[:, None] & ok_c[None, :] & (dy <= win_row) & (dxl <= win_col)
          & (dxr <= win_col) & (acc_l <= sad_max) & (acc_r <= sad_max))
    D = torch.where(ok, acc_l + acc_r, torch.full_like(acc_l, BIG))
    best_c = torch.argmin(D, dim=1)
    return best_c.to(torch.int32), torch.gather(D, 1, best_c[:, None])[:, 0]


def stereo_sad_fused_cuda(patches_l, patches_r, xy_l, xy_r, ok_l, ok_r,
                          max_y_diff: float, max_disp: float,
                          max_distance: float):
    _lib.load()
    dev = patches_l.device
    if not patches_l.is_cuda:
        raise ValueError(f"stereo_sad_fused_cuda: operands on {dev}")
    Kl, P = patches_l.shape
    Kr = patches_r.shape[0]
    if Kl == 0 or Kr == 0:
        raise ValueError("stereo_sad_fused_cuda: empty slot set")
    f32, b8 = torch.float32, torch.bool
    args = (_lib.check(patches_l, "patches_l", f32, (Kl, P), dev),
            _lib.check(patches_r, "patches_r", f32, (Kr, P), dev),
            _lib.check(xy_l, "xy_l", f32, (Kl, 2), dev),
            _lib.check(xy_r, "xy_r", f32, (Kr, 2), dev),
            _lib.check(ok_l, "ok_l", b8, (Kl,), dev),
            _lib.check(ok_r, "ok_r", b8, (Kr,), dev))
    best_r = torch.empty(Kl, dtype=torch.int32, device=dev)
    best_d = torch.empty(Kl, dtype=f32, device=dev)
    second = torch.empty(Kl, dtype=f32, device=dev)
    _lib.launch("stereo_sad_fused", *args, Kl, Kr, P, _f32(max_y_diff),
                _f32(max_disp), _f32(max_distance), best_r.data_ptr(),
                best_d.data_ptr(), second.data_ptr())
    return best_r, best_d, second


def track_sad_fused_cuda(p_left_patch, c_left_patch, p_right_patch,
                         c_right_patch, p_left_xy, c_left_xy, p_right_x,
                         c_right_x, ok_p, ok_c, win_row: float,
                         win_col: float, sad_max: float):
    _lib.load()
    dev = p_left_patch.device
    if not p_left_patch.is_cuda:
        raise ValueError(f"track_sad_fused_cuda: operands on {dev}")
    Kp, P = p_left_patch.shape
    Kc = c_left_patch.shape[0]
    if Kp == 0 or Kc == 0:
        raise ValueError("track_sad_fused_cuda: empty slot set")
    f32, b8 = torch.float32, torch.bool
    args = (_lib.check(p_left_patch, "p_left_patch", f32, (Kp, P), dev),
            _lib.check(c_left_patch, "c_left_patch", f32, (Kc, P), dev),
            _lib.check(p_right_patch, "p_right_patch", f32, (Kp, P), dev),
            _lib.check(c_right_patch, "c_right_patch", f32, (Kc, P), dev),
            _lib.check(p_left_xy, "p_left_xy", f32, (Kp, 2), dev),
            _lib.check(c_left_xy, "c_left_xy", f32, (Kc, 2), dev),
            _lib.check(p_right_x, "p_right_x", f32, (Kp,), dev),
            _lib.check(c_right_x, "c_right_x", f32, (Kc,), dev),
            _lib.check(ok_p, "ok_p", b8, (Kp,), dev),
            _lib.check(ok_c, "ok_c", b8, (Kc,), dev))
    best_c = torch.empty(Kp, dtype=torch.int32, device=dev)
    best_d = torch.empty(Kp, dtype=f32, device=dev)
    _lib.launch("track_sad_fused", *args, Kp, Kc, P, _f32(win_row),
                _f32(win_col), _f32(sad_max), best_c.data_ptr(),
                best_d.data_ptr())
    return best_c, best_d


def stereo_sad_fused_auto(*args, **kw):
    """The twin for CPU tensors, the CUDA kernel for anything else."""
    if args[0].device.type == "cpu":
        return stereo_sad_fused_torch(*args, **kw)
    return stereo_sad_fused_cuda(*args, **kw)


def track_sad_fused_auto(*args, **kw):
    """The twin for CPU tensors, the CUDA kernel for anything else."""
    if args[0].device.type == "cpu":
        return track_sad_fused_torch(*args, **kw)
    return track_sad_fused_cuda(*args, **kw)
