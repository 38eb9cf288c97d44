"""rso_torch — the rso stereo visual odometry engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package `rso` is the reference: every module here has a counterpart
of the same name there, and `tests/test_torch_*.py` hold the two against each
other on the CPU.  This package imports `torch` and never `jax`.
"""

__version__ = "0.1.0"

import torch as _torch

# Coordinates of ~1000 px lose whole pixels under TF32 (about three decimal
# digits), which breaks RANSAC gating and the pose solve's normal equations;
# the reference forces full f32 matmuls for the same reason
# (rso/__init__.py).  Both switches are process-wide PyTorch settings.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from rso_torch.config import RSOConfig, load_config  # noqa: E402

__all__ = ["RSOConfig", "load_config", "__version__"]
