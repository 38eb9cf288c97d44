"""Hand-written CUDA kernels (csrc/*.cu, sm_90a) with plain PyTorch twins.

Each module holds `<name>_torch` (the twin, used for CPU tensors),
`<name>_cuda` (the kernel wrapper) and `<name>_auto` (the dispatcher);
`eigh6` has the twin alone: the pose solver's 6x6 eigensolver, whose
routine the `gn_iter` kernel runs (csrc/eigh6.cuh); the plain GN iteration
takes it on the GPU and LAPACK's eigh on the CPU (rso_torch.solver.robust_gn).
`gn_iter`, one iteration of the pose solver's GN loop, has neither twin
nor dispatcher here: its plain version and the dispatch are the solver's
(`robust_gn.gn_iteration_torch`, `robust_gn.gn_iteration`).  Nor has
`lk_track`, a whole pyramidal-LK call: its plain version and the dispatch
are the optical-flow module's (`optical_flow.lk_track_torch`,
`optical_flow.lk_track`, `optical_flow.lk_track_eyes`).  Nor has `ransac`, a
whole fundamental-matrix RANSAC call: its plain version and the dispatch are
the solver's (`ransac.ransac_fundamental_torch`, `ransac.ransac_fundamental`).
`LAUNCHES` counts kernel launches by name.  Each `<name>_cuda` is a
`torch.library.custom_op` with a vmap rule: under torch.func.vmap (the
batched engine step) one launch covers every lane.  `cost_volume` is the
exception: the reference's windowed SAD search is plain XLA, not a Pallas
kernel, so its counterpart is plain PyTorch.
"""
from rso_torch.kernels._lib import LAUNCHES
from rso_torch.kernels.cost_volume import WindowedSearchResult, windowed_sad_search
from rso_torch.kernels.distance import (
    hamming_matrix_auto,
    hamming_matrix_cuda,
    hamming_matrix_torch,
    sad_matrix_auto,
    sad_matrix_cuda,
    sad_matrix_torch,
)
from rso_torch.kernels.eigh6 import eigh6_torch
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
    "WindowedSearchResult",
    "corner_response_auto",
    "corner_response_cuda",
    "corner_response_torch",
    "eigh6_torch",
    "hamming_matrix_auto",
    "hamming_matrix_cuda",
    "hamming_matrix_torch",
    "nullvec9_auto",
    "nullvec9_cuda",
    "nullvec9_torch",
    "sad_matrix_auto",
    "sad_matrix_cuda",
    "sad_matrix_torch",
    "stereo_sad_fused_auto",
    "stereo_sad_fused_cuda",
    "stereo_sad_fused_torch",
    "track_sad_fused_auto",
    "track_sad_fused_cuda",
    "track_sad_fused_torch",
    "windowed_sad_search",
]
