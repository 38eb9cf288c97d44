"""Rotation-vector (Rodrigues) utilities with closed-form derivatives.

Counterpart of rso/geometry/rotations.py: R(w), all nine dR/dw_k terms and
the inverse map, with the same small-angle branch at ||w|| < 1e-5, selected
by `torch.where` so no branch reads a value back to the host.
"""
from __future__ import annotations

import torch

_SMALL = 1e-5


def _hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (batched over leading dims)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(w: torch.Tensor, batch_invariant: bool = False) -> torch.Tensor:
    """R = I + v*[w]x + u*[w]x^2 with u=(1 - cos t)/t^2, v=sin t / t;
    small angle: R = I + [w]x.

    batch_invariant forms [w]x^2 from three elementwise products: a matmul
    sums in another order for another batch count (on the CPU and the GPU
    alike), these in none, so a rotation has the same bits alone and in a
    batch of any shape."""
    t2 = torch.sum(w * w, dim=-1)
    t = torch.sqrt(t2)
    small = t < _SMALL
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    u = torch.where(small, torch.full_like(t, 0.5), (1.0 - torch.cos(t)) / safe_t2)
    v = torch.where(small, torch.ones_like(t),
                    torch.sin(t) / torch.where(small, torch.ones_like(t), t))
    K = _hat(w)
    if batch_invariant:
        K2 = (K[..., :, 0, None] * K[..., None, 0, :]
              + K[..., :, 1, None] * K[..., None, 1, :]
              + K[..., :, 2, None] * K[..., None, 2, :])
    else:
        K2 = K @ K
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    R_full = eye + v[..., None, None] * K + u[..., None, None] * K2
    R_small = eye + K
    return torch.where(small[..., None, None], R_small, R_full)


def rodrigues_with_grad(w: torch.Tensor):
    """Return (R [...,3,3], dR [...,3,3,3]) where dR[..., k, :, :] =
    dR/dw_k, for one rotation vector [3] or a batch [...,3]."""
    w1, w2, w3 = w[..., 0], w[..., 1], w[..., 2]
    t2 = w1 * w1 + w2 * w2 + w3 * w3
    t = torch.sqrt(t2)
    small = t < _SMALL
    one = torch.ones_like(t)

    safe_t = torch.where(small, one, t)
    safe_t2 = torch.where(small, one, t2)
    safe_t3 = safe_t2 * safe_t
    safe_t4 = safe_t2 * safe_t2
    sin_t = torch.sin(t)
    cos_t = torch.cos(t)

    u = (1.0 - cos_t) / safe_t2
    v = sin_t / safe_t
    du = (((sin_t / safe_t) * safe_t2 - (1.0 - cos_t) * 2.0) / safe_t4)[..., None] * w
    dv = ((safe_t * cos_t - sin_t) / safe_t3)[..., None] * w

    K = _hat(w)
    K2 = K @ K
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    u2, v2 = u[..., None, None], v[..., None, None]
    R_full = eye + v2 * K + u2 * K2

    E = _hat(eye)                                       # [3,3,3]: dK/dw_k
    dK2 = (torch.einsum("kij,...jl->...kil", E, K)
           + torch.einsum("...ij,kjl->...kil", K, E))
    dR_full = (dv[..., :, None, None] * K[..., None, :, :] + v2[..., None] * E
               + du[..., :, None, None] * K2[..., None, :, :]
               + u2[..., None] * dK2)

    R = torch.where(small[..., None, None], eye + K, R_full)
    dR = torch.where(small[..., None, None, None], E, dR_full)
    return R, dR


def rotvec_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues through the quaternion, branch-free: all four
    quaternion extractions are computed and the best-conditioned one taken."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def _s(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2.0

    s = _s(tr + 1.0)
    cw = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s])
    s = _s(1.0 + m00 - m11 - m22)
    cx = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s])
    s = _s(1.0 + m11 - m00 - m22)
    cy = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s])
    s = _s(1.0 + m22 - m00 - m11)
    cz = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s])

    cands = torch.stack([cw, cx, cy, cz])
    scores = torch.stack([tr, m00, m11, m22])
    q = cands[torch.argmax(scores)]
    q = q / torch.linalg.norm(q)
    q = torch.where(q[0] < 0, -q, q)
    qw = torch.clamp(q[0], -1.0, 1.0)
    angle = 2.0 * torch.arccos(qw)
    s = torch.sqrt(torch.clamp(1.0 - qw * qw, min=0.0))
    tiny = s < 1e-7
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=R.dtype, device=R.device)
    axis = torch.where(tiny, x_axis,
                       q[1:] / torch.where(tiny, torch.ones_like(s), s))
    return axis * angle
