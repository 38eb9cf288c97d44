"""Pyramidal Lucas-Kanade tracking as one CUDA kernel (csrc/lk_track.cu).

No TPU kernel of the reference: rso's LK is plain XLA
(rso/frontend/optical_flow.py `lk_track`).  The port's plain version is
`rso_torch.frontend.optical_flow.lk_track_torch`, which the CPU keeps;
`optical_flow.lk_track` and `lk_track_eyes` take this kernel for CUDA
tensors, eager and captured alike.  One launch runs a whole `lk_track`
call: the coarse SAD seed, every level's iterations, the residual and the
status gates, for every keypoint of up to two eyes (a block a keypoint and
eye).  See the header of csrc/lk_track.cu for the design and its bound on
the H100.

The custom op `rso_torch::lk_track` has a vmap rule: under torch.func.vmap
(the batched engine step) one launch runs every lane, the grid's z axis.
"""
from __future__ import annotations

import ctypes

import torch

from rso_torch.kernels import _lib

MAX_LEVELS = 8
MAX_WIN = 10     # 21x21, the port's window (one build of the kernel)


def _launch(prev, cur, pts, valid, win, iters, seed_range, max_err):
    """One launch over B lanes: `prev` and `cur` E x L levels, eye-major,
    each [B, h, w]; pts [B, E, K, 2], valid [B, E, K]."""
    dev = pts.device
    B, E, K, _ = pts.shape
    L = len(prev) // E
    if not (1 <= E <= 2 and 1 <= L <= MAX_LEVELS and len(prev) == E * L
            and len(cur) == E * L):
        raise ValueError(f"lk_track_cuda: {len(prev)} / {len(cur)} pyramid "
                         f"levels for {E} eye(s)")
    if not 1 <= win <= MAX_WIN:
        raise ValueError(f"lk_track_cuda: win {win} (the kernel takes 1 to "
                         f"{MAX_WIN})")
    f32 = torch.float32
    hw = [tuple(prev[lvl].shape[-2:]) for lvl in range(L)]
    ptrs = []
    for side, imgs in (("prev", prev), ("cur", cur)):
        ptrs.append([_lib.check(img, f"{side}[{i}]", f32, (B, *hw[i % L]), dev)
                     for i, img in enumerate(imgs)])
    args = (_lib.check(pts, "pts", f32, (B, E, K, 2), dev),
            _lib.check(valid, "valid", torch.bool, (B, E, K), dev))
    pos = torch.empty((B, E, K, 2), dtype=f32, device=dev)
    status = torch.empty((B, E, K), dtype=torch.bool, device=dev)
    err = torch.empty((B, E, K), dtype=f32, device=dev)
    if K == 0:
        return pos, status, err
    arr = ctypes.c_void_p * (E * L)
    dims = (ctypes.c_int * (2 * L))(*(n for d in hw for n in d))
    _lib.launch("lk_track", arr(*ptrs[0]), arr(*ptrs[1]), dims, B, E, K, L,
                *args, win, iters, seed_range, max_err, pos.data_ptr(),
                status.data_ptr(), err.data_ptr())
    return pos, status, err


@torch.library.custom_op(
    "rso_torch::lk_track", mutates_args=(), device_types="cuda",
    schema="(Tensor[] prev, Tensor[] cur, Tensor pts, Tensor valid, int win, "
           "int iters, int seed_range, float max_err) -> (Tensor, Tensor, "
           "Tensor)")
def _lk_op(prev, cur, pts, valid, win, iters, seed_range, max_err):
    out = _launch([p[None] for p in prev], [c[None] for c in cur], pts[None],
                  valid[None], win, iters, seed_range, max_err)
    return tuple(o[0] for o in out)


@torch.library.register_vmap("rso_torch::lk_track")
def _lk_lanes(info, in_dims, prev, cur, pts, valid, *scalars):
    """vmap: one launch for every lane (the grid's z axis)."""
    B = info.batch_size
    prev = _lib.lanes(B, in_dims[0], prev)
    cur = _lib.lanes(B, in_dims[1], cur)
    pts, valid = _lib.lanes(B, in_dims[2:4], (pts, valid))
    return _launch(prev, cur, pts, valid, *scalars), (0, 0, 0)


def lk_track_cuda(prev_pyrs: list, cur_pyrs: list, pts: torch.Tensor,
                  valid: torch.Tensor, win: int, iters: int, max_err: float,
                  seed_range: int):
    """The kernel (custom op `rso_torch::lk_track`) over E eyes:
    `prev_pyrs`, `cur_pyrs` one pyramid (list of levels, octave 0 first)
    an eye, pts [E, K, 2] (octave-0 coords of the pyramids), valid [E, K].
    Returns (pos [E, K, 2], status [E, K], err [E, K])."""
    _lib.require_cuda("lk_track_cuda", pts)
    prev = [lvl.contiguous() for pyr in prev_pyrs for lvl in pyr]
    cur = [lvl.contiguous() for pyr in cur_pyrs for lvl in pyr]
    return _lk_op(prev, cur, pts.contiguous(), valid.contiguous(), int(win),
                  int(iters), int(seed_range), float(max_err))
