"""Kernel 1: FAST corner test + Shi-Tomasi response over one octave image.

Replaces rso/kernels/fast_detect.py `corner_response_pallas` (see the header
of csrc/fast_detect.cu for the border semantics, the H100 bound and the
design).  `corner_response_torch` is the plain PyTorch twin: the
`fast_corner_mask` + `shi_tomasi_response` composition of the reference's
`corner_response_jnp`.  The CUDA kernel equals the twin bit for bit, mask
and response: the same summation order, no FMA contraction, and the window
mean as a multiply by the same float32 reciprocal.
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


def corner_response_cuda(img: torch.Tensor, threshold, arc: int = 12,
                         win: int = 4) -> torch.Tensor:
    """The CUDA kernel; `threshold` is an int scalar or a 0-d/1-element int32
    tensor on the image's device (read on the device, no host sync)."""
    _lib.load()
    if not img.is_cuda:
        raise ValueError(f"corner_response_cuda: image on {img.device}")
    if not 1 <= arc <= 16:
        raise ValueError(f"arc must be in 1..16, got {arc}")
    H, W = img.shape
    th = torch.as_tensor(threshold, dtype=torch.int32, device=img.device)
    th = th.reshape(1).contiguous()
    img_p = _lib.check(img, "img", torch.float32, (H, W), img.device)
    out = torch.empty_like(img)
    _lib.launch("corner_response", img_p, th.data_ptr(), out.data_ptr(),
                H, W, arc, win)
    return out


def corner_response_auto(img: torch.Tensor, threshold, arc: int = 12,
                         win: int = 4) -> torch.Tensor:
    """The twin for a CPU tensor, the CUDA kernel for anything else."""
    if img.device.type == "cpu":
        return corner_response_torch(img, threshold, arc, win)
    return corner_response_cuda(img, threshold, arc, win)
