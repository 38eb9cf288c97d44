"""Kernels 2 and 3: fused exact-SAD cores of stereo matching and tracking.

Replace rso/kernels/stereo_fused.py `stereo_sad_fused` and `track_sad_fused`
(see the header of csrc/stereo_fused.cu for the H100 bound and the design).
The `*_torch` twins compute the same masked all-pairs SAD as dense [K,K]
planes.  Both kernels evaluate the geometric and validity mask first and
form the SAD only of the pairs it admits (a row with none gives index 0 and
1e9, as the twin's argmin over a row of 1e9).  Every SAD is an exact f32
sum, so kernel and twin agree bit for bit.

The `*_cuda` wrappers are custom ops with vmap rules: under torch.func.vmap,
as in the batched engine step, one launch covers every lane (the grid's y
axis).
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


def _stereo_launch(pl, pr, xyl, xyr, okl, okr, max_y_diff, max_disp,
                   max_distance):
    """One launch over B lanes: every operand with a leading [B] axis."""
    dev = pl.device
    B, Kl, P = pl.shape
    Kr = pr.shape[1]
    if Kl == 0 or Kr == 0:
        raise ValueError("stereo_sad_fused_cuda: empty slot set")
    f32, b8 = torch.float32, torch.bool
    args = (_lib.check(pl, "patches_l", f32, (B, Kl, P), dev),
            _lib.check(pr, "patches_r", f32, (B, Kr, P), dev),
            _lib.check(xyl, "xy_l", f32, (B, Kl, 2), dev),
            _lib.check(xyr, "xy_r", f32, (B, Kr, 2), dev),
            _lib.check(okl, "ok_l", b8, (B, Kl), dev),
            _lib.check(okr, "ok_r", b8, (B, Kr), dev))
    best_r = torch.empty((B, Kl), dtype=torch.int32, device=dev)
    best_d = torch.empty((B, Kl), dtype=f32, device=dev)
    second = torch.empty((B, Kl), dtype=f32, device=dev)
    _lib.launch("stereo_sad_fused", *args, B, Kl, Kr, P, max_y_diff,
                max_disp, max_distance, best_r.data_ptr(), best_d.data_ptr(),
                second.data_ptr())
    return best_r, best_d, second


def _track_launch(p_left_patch, c_left_patch, p_right_patch, c_right_patch,
                  p_left_xy, c_left_xy, p_right_x, c_right_x, ok_p, ok_c,
                  win_row, win_col, sad_max):
    """One launch over B lanes: every operand with a leading [B] axis."""
    dev = p_left_patch.device
    B, Kp, P = p_left_patch.shape
    Kc = c_left_patch.shape[1]
    if Kp == 0 or Kc == 0:
        raise ValueError("track_sad_fused_cuda: empty slot set")
    f32, b8 = torch.float32, torch.bool
    args = (_lib.check(p_left_patch, "p_left_patch", f32, (B, Kp, P), dev),
            _lib.check(c_left_patch, "c_left_patch", f32, (B, Kc, P), dev),
            _lib.check(p_right_patch, "p_right_patch", f32, (B, Kp, P), dev),
            _lib.check(c_right_patch, "c_right_patch", f32, (B, Kc, P), dev),
            _lib.check(p_left_xy, "p_left_xy", f32, (B, Kp, 2), dev),
            _lib.check(c_left_xy, "c_left_xy", f32, (B, Kc, 2), dev),
            _lib.check(p_right_x, "p_right_x", f32, (B, Kp), dev),
            _lib.check(c_right_x, "c_right_x", f32, (B, Kc), dev),
            _lib.check(ok_p, "ok_p", b8, (B, Kp), dev),
            _lib.check(ok_c, "ok_c", b8, (B, Kc), dev))
    best_c = torch.empty((B, Kp), dtype=torch.int32, device=dev)
    best_d = torch.empty((B, Kp), dtype=f32, device=dev)
    _lib.launch("track_sad_fused", *args, B, Kp, Kc, P, win_row, win_col,
                sad_max, best_c.data_ptr(), best_d.data_ptr())
    return best_c, best_d


@torch.library.custom_op(
    "rso_torch::stereo_sad_fused", mutates_args=(), device_types="cuda",
    schema="(Tensor pl, Tensor pr, Tensor xyl, Tensor xyr, Tensor okl, "
           "Tensor okr, float max_y_diff, float max_disp, float max_distance)"
           " -> (Tensor, Tensor, Tensor)")
def _stereo_op(pl, pr, xyl, xyr, okl, okr, max_y_diff, max_disp,
               max_distance):
    out = _stereo_launch(pl[None], pr[None], xyl[None], xyr[None], okl[None],
                         okr[None], max_y_diff, max_disp, max_distance)
    return tuple(o[0] for o in out)


@torch.library.register_vmap("rso_torch::stereo_sad_fused")
def _stereo_lanes(info, in_dims, *args):
    """vmap: one launch for every lane (the grid's y axis)."""
    ts = _lib.lanes(info.batch_size, in_dims[:6], args[:6])
    return _stereo_launch(*ts, *args[6:]), (0, 0, 0)


@torch.library.custom_op(
    "rso_torch::track_sad_fused", mutates_args=(), device_types="cuda",
    schema="(Tensor p_left_patch, Tensor c_left_patch, Tensor p_right_patch,"
           " Tensor c_right_patch, Tensor p_left_xy, Tensor c_left_xy, "
           "Tensor p_right_x, Tensor c_right_x, Tensor ok_p, Tensor ok_c, "
           "float win_row, float win_col, float sad_max) -> (Tensor, Tensor)")
def _track_op(p_left_patch, c_left_patch, p_right_patch, c_right_patch,
              p_left_xy, c_left_xy, p_right_x, c_right_x, ok_p, ok_c,
              win_row, win_col, sad_max):
    ts = (p_left_patch, c_left_patch, p_right_patch, c_right_patch,
          p_left_xy, c_left_xy, p_right_x, c_right_x, ok_p, ok_c)
    out = _track_launch(*(t[None] for t in ts), win_row, win_col, sad_max)
    return tuple(o[0] for o in out)


@torch.library.register_vmap("rso_torch::track_sad_fused")
def _track_lanes(info, in_dims, *args):
    """vmap: one launch for every lane (the grid's y axis)."""
    ts = _lib.lanes(info.batch_size, in_dims[:10], args[:10])
    return _track_launch(*ts, *args[10:]), (0, 0)


def stereo_sad_fused_cuda(patches_l, patches_r, xy_l, xy_r, ok_l, ok_r,
                          max_y_diff: float, max_disp: float,
                          max_distance: float):
    """The CUDA kernel (custom op `rso_torch::stereo_sad_fused`); under
    torch.func.vmap one launch takes every lane."""
    _lib.require_cuda("stereo_sad_fused_cuda", patches_l)
    return _stereo_op(patches_l, patches_r, xy_l, xy_r, ok_l, ok_r,
                      _f32(max_y_diff), _f32(max_disp), _f32(max_distance))


def track_sad_fused_cuda(p_left_patch, c_left_patch, p_right_patch,
                         c_right_patch, p_left_xy, c_left_xy, p_right_x,
                         c_right_x, ok_p, ok_c, win_row: float,
                         win_col: float, sad_max: float):
    """The CUDA kernel (custom op `rso_torch::track_sad_fused`); under
    torch.func.vmap one launch takes every lane."""
    _lib.require_cuda("track_sad_fused_cuda", p_left_patch)
    return _track_op(p_left_patch, c_left_patch, p_right_patch,
                     c_right_patch, p_left_xy, c_left_xy, p_right_x,
                     c_right_x, ok_p, ok_c, _f32(win_row), _f32(win_col),
                     _f32(sad_max))


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
