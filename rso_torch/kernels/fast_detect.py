"""Kernel 1: FAST corner test + Shi-Tomasi response over one octave image.

Replaces rso/kernels/fast_detect.py `corner_response_pallas` (see the header
of csrc/fast_detect.cu for the border semantics, the H100 bound and the
design: a shared-memory tile per block, sized from `win` at launch, the
gradients and products computed once per position, separable box sums;
where that tile does not fit a block's shared memory, win > 45 on the H100,
the wide path: the column sums to global memory, then the row sums, the
response and the FAST test, in two launches).  `corner_response_torch` is
the plain PyTorch twin: the `fast_corner_mask` + `shi_tomasi_response`
composition of the reference's `corner_response_jnp`.  The CUDA kernel
equals the twin bit for bit, mask and response: the same summation order
(each column's rows, then the column sums), no FMA contraction, and the
window mean as a multiply by the same float32 reciprocal.

`corner_response_cuda` is a custom op (`rso_torch::corner_response`) with a
vmap rule: under torch.func.vmap, as in the batched engine step, one launch
covers every lane (the grid's z axis), each with its own threshold.
"""
from __future__ import annotations

import torch

from rso_torch.kernels import _lib


def corner_response_torch(img: torch.Tensor, threshold, arc: int = 12,
                          win: int = 4) -> torch.Tensor:
    """where(fast_corner_mask, shi_tomasi_response, -inf) — [H,W] f32."""
    from rso_torch.frontend.detect import fast_corner_mask, shi_tomasi_response

    img = img.to(torch.float32)
    corner = fast_corner_mask(img, threshold, arc=arc)
    resp = shi_tomasi_response(img, win)
    return torch.where(corner, resp, torch.full_like(resp, -torch.inf))


def _launch(img: torch.Tensor, threshold: torch.Tensor, arc: int,
            win: int) -> torch.Tensor:
    """One launch over B images: img [B,H,W] f32, threshold [B] int32."""
    B, H, W = img.shape
    dev = img.device
    img_p = _lib.check(img, "img", torch.float32, (B, H, W), dev)
    th_p = _lib.check(threshold, "threshold", torch.int32, (B,), dev)
    out = torch.empty_like(img)
    if _lib.tile_fits(win):
        _lib.launch("corner_response", img_p, th_p, out.data_ptr(), None, B,
                    H, W, arc, win)
    else:
        # the wide path's column sums of the three products
        colsum = torch.empty((B, 3, H, W), dtype=torch.float32, device=dev)
        _lib.launch("corner_response", img_p, th_p, out.data_ptr(),
                    colsum.data_ptr(), B, H, W, arc, win,
                    counted_as="corner_response_wide")
    return out


@torch.library.custom_op(
    "rso_torch::corner_response", mutates_args=(), device_types="cuda",
    schema="(Tensor img, Tensor threshold, int arc, int win) -> Tensor")
def _corner_response_op(img, threshold, arc, win):
    return _launch(img[None], threshold.reshape(1), arc, win)[0]


@torch.library.register_vmap("rso_torch::corner_response")
def _corner_response_lanes(info, in_dims, img, threshold, arc, win):
    """vmap: one launch for every lane, each with its own threshold."""
    img, threshold = _lib.lanes(info.batch_size, in_dims[:2],
                                (img, threshold))
    return _launch(img, threshold.reshape(info.batch_size), arc, win), 0


def corner_response_cuda(img: torch.Tensor, threshold, arc: int = 12,
                         win: int = 4) -> torch.Tensor:
    """The CUDA kernel; `threshold` is an int scalar or a 0-d/1-element int32
    tensor on the image's device (read on the device, no host sync).  Its
    launches count as `corner_response` on the one-tile path and as
    `corner_response_wide` where the window's tile does not fit.  Under
    torch.func.vmap one launch takes every lane's image and threshold."""
    if not 1 <= arc <= 16:
        raise ValueError(f"arc must be in 1..16, got {arc}")
    if win < 1:
        raise ValueError(f"win must be >= 1, got {win}")
    _lib.load()
    if not img.is_cuda:
        raise ValueError(f"corner_response_cuda: image on {img.device}")
    th = (threshold.to(img.device, torch.int32)
          if isinstance(threshold, torch.Tensor)
          else torch.full((), threshold, dtype=torch.int32, device=img.device))
    return _corner_response_op(img, th.reshape(()), arc, win)


def corner_response_auto(img: torch.Tensor, threshold, arc: int = 12,
                         win: int = 4) -> torch.Tensor:
    """The twin for a CPU tensor, the CUDA kernel for anything else."""
    if img.device.type == "cpu":
        return corner_response_torch(img, threshold, arc, win)
    return corner_response_cuda(img, threshold, arc, win)
