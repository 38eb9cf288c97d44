"""Kernels 5 and 6: the all-pairs Hamming and SAD matrices.

Replace rso/kernels/distance.py `hamming_matrix_pallas` and
`sad_matrix_pallas` (see the header of csrc/distance.cu for the H100 bound
and the design).  The descriptor modes call the Hamming matrix, the dense
SAD path (`use_fused_match=False`) the SAD matrix.  Both twins compute exact
values: Hamming distances are integer counts, and the SAD of the port's
patches (multiples of 1/16 below 256) is an exact f32 sum, so kernel and
twin agree bit for bit.
"""
from __future__ import annotations

import torch

from rso_torch.kernels import _lib
from rso_torch.kernels.stereo_fused import _sad

_MAX_P = 128   # both kernels' staged tiles stay under 48 KB of shared memory


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word, for int64 values in [0, 2^32): SWAR.
    (PyTorch has no popcount; int32 `>>` is arithmetic, so the words are
    widened and masked first.)"""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matrix_torch(desc_a: torch.Tensor,
                         desc_b: torch.Tensor) -> torch.Tensor:
    """[Ka,W] x [Kb,W] int32 words (uint32 bits) -> [Ka,Kb] f32 Hamming."""
    x = torch.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return _popcount32(x.to(torch.int64) & 0xFFFFFFFF).sum(-1).to(torch.float32)


def sad_matrix_torch(patches_a: torch.Tensor,
                     patches_b: torch.Tensor) -> torch.Tensor:
    """[Ka,P] x [Kb,P] f32 -> [Ka,Kb] sum of absolute differences."""
    return _sad(patches_a.float(), patches_b.float())


def _operands(name, a, b, dtype, max_width):
    _lib.load()
    dev = a.device
    if not a.is_cuda:
        raise ValueError(f"{name}: operands on {dev}")
    Ka, width = a.shape
    Kb = b.shape[0]
    if Ka == 0 or Kb == 0:
        raise ValueError(f"{name}: empty slot set")
    if not 1 <= width <= max_width:
        raise ValueError(f"{name}: row width {width} outside 1..{max_width}")
    return (_lib.check(a, "a", dtype, (Ka, width), dev),
            _lib.check(b, "b", dtype, (Kb, width), dev), Ka, Kb, width)


def hamming_matrix_cuda(desc_a: torch.Tensor,
                        desc_b: torch.Tensor) -> torch.Tensor:
    pa, pb, Ka, Kb, W = _operands("hamming_matrix_cuda", desc_a, desc_b,
                                  torch.int32, 64)
    out = torch.empty((Ka, Kb), dtype=torch.float32, device=desc_a.device)
    _lib.launch("hamming_matrix", pa, pb, Ka, Kb, W, out.data_ptr())
    return out


def sad_matrix_cuda(patches_a: torch.Tensor,
                    patches_b: torch.Tensor) -> torch.Tensor:
    pa, pb, Ka, Kb, P = _operands("sad_matrix_cuda", patches_a, patches_b,
                                  torch.float32, _MAX_P)
    out = torch.empty((Ka, Kb), dtype=torch.float32, device=patches_a.device)
    _lib.launch("sad_matrix", pa, pb, Ka, Kb, P, out.data_ptr())
    return out


def hamming_matrix_auto(desc_a: torch.Tensor,
                        desc_b: torch.Tensor) -> torch.Tensor:
    """The twin for CPU tensors, the CUDA kernel for anything else."""
    if desc_a.device.type == "cpu":
        return hamming_matrix_torch(desc_a, desc_b)
    return hamming_matrix_cuda(desc_a, desc_b)


def sad_matrix_auto(patches_a: torch.Tensor,
                    patches_b: torch.Tensor) -> torch.Tensor:
    """The twin for CPU tensors, the CUDA kernel for anything else."""
    if patches_a.device.type == "cpu":
        return sad_matrix_torch(patches_a, patches_b)
    return sad_matrix_cuda(patches_a, patches_b)
