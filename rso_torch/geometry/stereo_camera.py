"""Stereo pinhole camera model: triangulation, projection, analytic Jacobian.

Counterpart of rso/geometry/stereo_camera.py, vectorized over landmarks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rso_torch.geometry.rotations import rodrigues_with_grad


class StereoCamera(NamedTuple):
    """Rectified stereo pinhole pair; every entry is a 0-d float32 tensor.

    The reference casts its entries to float32 (rso/geometry/stereo_camera.py
    `make`), and 718.856 is not a float32 value, so the port holds the same
    float32 numbers: products of two entries round as they do there.
    """

    fx_l: torch.Tensor
    fy_l: torch.Tensor
    cx_l: torch.Tensor
    cy_l: torch.Tensor
    fx_r: torch.Tensor
    fy_r: torch.Tensor
    cx_r: torch.Tensor
    cy_r: torch.Tensor
    baseline: torch.Tensor

    @staticmethod
    def make(fx_l, fy_l, cx_l, cy_l, baseline, fx_r=None, fy_r=None,
             cx_r=None, cy_r=None, device="cpu") -> "StereoCamera":
        """Build a camera; right intrinsics default to the left ones."""
        def f(v):
            return torch.tensor(np.float32(v), dtype=torch.float32, device=device)

        return StereoCamera(
            f(fx_l), f(fy_l), f(cx_l), f(cy_l),
            f(fx_l if fx_r is None else fx_r),
            f(fy_l if fy_r is None else fy_r),
            f(cx_l if cx_r is None else cx_r),
            f(cy_l if cy_r is None else cy_r),
            f(baseline),
        )

    @staticmethod
    def from_numpy(cam, device="cpu") -> "StereoCamera":
        """From any object with the nine named fields (e.g. the reference's
        camera with each leaf passed through np.asarray)."""
        return StereoCamera(*(
            torch.tensor(np.asarray(getattr(cam, name), np.float32),
                         device=device)
            for name in StereoCamera._fields))

    def to(self, device) -> "StereoCamera":
        return StereoCamera(*(v.to(device) for v in self))


def triangulate(cam: StereoCamera, ul, vl, ur):
    """Closed-form stereo back-projection -> [N,3] left-camera landmarks
    (reference stage5_optimization.cpp:537-543)."""
    denom = cam.fx_l * (cam.cx_r - ur) + cam.fx_r * (ul - cam.cx_l)
    safe = torch.where(torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9),
                       denom)
    b_d = cam.baseline / safe
    X = b_d * cam.fx_r * (ul - cam.cx_l)
    Y = b_d * cam.fx_r * (vl - cam.cy_l)
    Z = b_d * cam.fx_l * cam.fx_r
    return torch.stack([X, Y, Z], dim=-1)


def _pixels(cam: StereoCamera, P: torch.Tensor):
    X1c, Y1c, Z1c = P[:, 0], P[:, 1], P[:, 2]
    Zs = torch.where(torch.abs(Z1c) < 1e-9, torch.full_like(Z1c, 1e-9), Z1c)
    X2c = X1c - cam.baseline
    ul = cam.fx_l * X1c / Zs + cam.cx_l
    vl = cam.fy_l * Y1c / Zs + cam.cy_l
    ur = cam.fx_r * X2c / Zs + cam.cx_r
    vr = cam.fy_r * Y1c / Zs + cam.cy_r
    return torch.stack([ul, vl, ur, vr], dim=-1), X1c, Y1c, X2c, Zs


def project_stereo(cam: StereoCamera, lmks: torch.Tensor,
                   delta_pose: torch.Tensor) -> torch.Tensor:
    """Project [N,3] landmarks through delta_pose to (uL,vL,uR,vR) [N,4]."""
    R, _ = rodrigues_with_grad(delta_pose[:3])
    return _pixels(cam, lmks @ R.T + delta_pose[3:])[0]


def project_stereo_with_jacobian(cam: StereoCamera, lmks: torch.Tensor,
                                 delta_pose: torch.Tensor):
    """Pixels [N,4] plus the per-landmark 4x6 Jacobian d(uL,vL,uR,vR)/d(w,t)."""
    R, dR = rodrigues_with_grad(delta_pose[:3])
    pix, X1c, Y1c, X2c, Zs = _pixels(cam, lmks @ R.T + delta_pose[3:])

    dP_rot = torch.einsum("kij,nj->nki", dR, lmks)            # [N,3,3]
    dP_trans = torch.eye(3, dtype=lmks.dtype,
                         device=lmks.device).expand(lmks.shape[0], 3, 3)
    dP = torch.cat([dP_rot, dP_trans], dim=1)                 # [N,6,3]
    Xd, Yd, Zd = dP[..., 0], dP[..., 1], dP[..., 2]

    Z2 = (Zs * Zs)[:, None]
    Zc = Zs[:, None]
    Ju_l = cam.fx_l * (Xd * Zc - X1c[:, None] * Zd) / Z2
    Jv_l = cam.fy_l * (Yd * Zc - Y1c[:, None] * Zd) / Z2
    Ju_r = cam.fx_r * (Xd * Zc - X2c[:, None] * Zd) / Z2
    Jv_r = cam.fy_r * (Yd * Zc - Y1c[:, None] * Zd) / Z2
    return pix, torch.stack([Ju_l, Jv_l, Ju_r, Jv_r], dim=1)  # [N,4,6]


def project_landmarks(cam: StereoCamera, ul, vl, ur, delta_pose):
    """Triangulate prev-frame observations and reproject them under
    delta_pose (reference getProjectedCoords, common.cpp:415-470)."""
    return project_stereo(cam, triangulate(cam, ul, vl, ur), delta_pose)
