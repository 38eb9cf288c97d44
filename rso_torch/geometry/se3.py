"""SE(3) pose utilities over (w1,w2,w3,t1,t2,t3) rotation-vector coords.

Counterpart of rso/geometry/se3.py: a pose is a [6] tensor [w, t] meaning
x_new = R(w) @ x + t.
"""
from __future__ import annotations

import torch

from rso_torch.geometry.rotations import rodrigues, rotvec_from_matrix


def pose_matrix(pose6: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous matrix of a [w,t] 6-vector; [...,4,4] of a [...,6]
    batch (the reference's jax.vmap(pose_matrix)), in one set of launches.
    A pose's matrix has the same bits alone and in any batch."""
    T = torch.eye(4, dtype=pose6.dtype, device=pose6.device).repeat(
        *pose6.shape[:-1], 1, 1)
    T[..., :3, :3] = rodrigues(pose6[..., :3], batch_invariant=True)
    T[..., :3, 3] = pose6[..., 3:]
    return T


def pose_inverse(pose6: torch.Tensor) -> torch.Tensor:
    """Inverse pose: (w,t)^-1 = (-w, -R(w)^T t)."""
    R = rodrigues(pose6[:3])
    return torch.cat([-pose6[:3], -(R.T @ pose6[3:])])


def pose_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ∘ b : apply b first, then a (the matrix product T_a @ T_b)."""
    Ra = rodrigues(a[:3])
    Rb = rodrigues(b[:3])
    t = Ra @ b[3:] + a[3:]
    return torch.cat([rotvec_from_matrix(Ra @ Rb), t])


def pose_apply(pose6: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Transform [...,3] points by the pose."""
    R = rodrigues(pose6[:3])
    return pts @ R.T + pose6[3:]
