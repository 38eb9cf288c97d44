"""Hand-written CUDA kernels (csrc/*.cu, sm_90a) with plain PyTorch twins.

Each module holds `<name>_torch` (the twin, used for CPU tensors),
`<name>_cuda` (the kernel wrapper) and `<name>_auto` (the dispatcher).
`LAUNCHES` counts kernel launches by name.
"""
from rso_torch.kernels._lib import LAUNCHES
from rso_torch.kernels.fast_detect import (
    corner_response_auto,
    corner_response_cuda,
    corner_response_torch,
)
from rso_torch.kernels.smallchol import nullvec9_auto, nullvec9_cuda, nullvec9_torch
from rso_torch.kernels.stereo_fused import (
    stereo_sad_fused_auto,
    stereo_sad_fused_cuda,
    stereo_sad_fused_torch,
    track_sad_fused_auto,
    track_sad_fused_cuda,
    track_sad_fused_torch,
)

__all__ = [
    "LAUNCHES",
    "corner_response_auto",
    "corner_response_cuda",
    "corner_response_torch",
    "nullvec9_auto",
    "nullvec9_cuda",
    "nullvec9_torch",
    "stereo_sad_fused_auto",
    "stereo_sad_fused_cuda",
    "stereo_sad_fused_torch",
    "track_sad_fused_auto",
    "track_sad_fused_cuda",
    "track_sad_fused_torch",
]
