"""Kernels 5 and 6: the all-pairs Hamming and SAD matrices.

Replace rso/kernels/distance.py `hamming_matrix_pallas` and
`sad_matrix_pallas` (see the header of csrc/distance.cu for the H100 bound
and the design).  The descriptor modes call the Hamming matrix, the dense
SAD path (`use_fused_match=False`) the SAD matrix.  Both twins compute exact
values: Hamming distances are integer counts, and the SAD of the port's
patches (multiples of 1/16 below 256) is an exact f32 sum, so kernel and
twin agree bit for bit.  The `*_cuda` wrappers are custom ops with vmap
rules: under torch.func.vmap one launch covers every lane (the grid's z
axis).
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


def _matrix_launch(name, a, b, dtype, max_width) -> torch.Tensor:
    """One launch of C entry `rso_<name>` over B lanes: a [B,Ka,w],
    b [B,Kb,w] -> [B,Ka,Kb] f32."""
    dev = a.device
    B, Ka, width = a.shape
    Kb = b.shape[1]
    if Ka == 0 or Kb == 0:
        raise ValueError(f"{name}_cuda: empty slot set")
    if not 1 <= width <= max_width:
        raise ValueError(f"{name}_cuda: row width {width} outside "
                         f"1..{max_width}")
    pa = _lib.check(a, "a", dtype, (B, Ka, width), dev)
    pb = _lib.check(b, "b", dtype, (B, Kb, width), dev)
    out = torch.empty((B, Ka, Kb), dtype=torch.float32, device=dev)
    _lib.launch(name, pa, pb, B, Ka, Kb, width, out.data_ptr())
    return out


def _hamming_launch(a, b):
    return _matrix_launch("hamming_matrix", a, b, torch.int32, 64)


def _sad_launch(a, b):
    return _matrix_launch("sad_matrix", a, b, torch.float32, _MAX_P)


@torch.library.custom_op("rso_torch::hamming_matrix", mutates_args=(),
                         device_types="cuda",
                         schema="(Tensor a, Tensor b) -> Tensor")
def _hamming_op(a, b):
    return _hamming_launch(a[None], b[None])[0]


@torch.library.custom_op("rso_torch::sad_matrix", mutates_args=(),
                         device_types="cuda",
                         schema="(Tensor a, Tensor b) -> Tensor")
def _sad_op(a, b):
    return _sad_launch(a[None], b[None])[0]


@torch.library.register_vmap("rso_torch::hamming_matrix")
def _hamming_lanes(info, in_dims, a, b):
    """vmap: one launch for every lane (the grid's z axis)."""
    return _hamming_launch(*_lib.lanes(info.batch_size, in_dims, (a, b))), 0


@torch.library.register_vmap("rso_torch::sad_matrix")
def _sad_lanes(info, in_dims, a, b):
    """vmap: one launch for every lane (the grid's z axis)."""
    return _sad_launch(*_lib.lanes(info.batch_size, in_dims, (a, b))), 0


def hamming_matrix_cuda(desc_a: torch.Tensor,
                        desc_b: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (custom op `rso_torch::hamming_matrix`)."""
    _lib.require_cuda("hamming_matrix_cuda", desc_a)
    return _hamming_op(desc_a, desc_b)


def sad_matrix_cuda(patches_a: torch.Tensor,
                    patches_b: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (custom op `rso_torch::sad_matrix`)."""
    _lib.require_cuda("sad_matrix_cuda", patches_a)
    return _sad_op(patches_a, patches_b)


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
