"""Synthetic stereo blob sequence with exact ground truth (host numpy).

A copy of `make_sequence`, `render_frame` and `synthetic_config` from
rso/synthetic.py, which cannot be imported here because it loads jax.  Same
seed, same numpy calls in the same order, so the same arguments give the same
frames as the reference's generator.  The unrectified-rig options of the
reference's `render_frame` (`dist`, `R_lr`) belong to the rectification path
(ROADMAP Queue 1 #12) and are left out.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from rso_torch.config import RSOConfig
from rso_torch.geometry.stereo_camera import StereoCamera


def synthetic_config() -> RSOConfig:
    """RSOConfig tuned for the synthetic blob sequences: SAD thresholds
    scaled for their sharp gradients and a 1 px epipolar tolerance."""
    cfg = RSOConfig()
    return cfg.replace(
        lr_match=dataclasses.replace(
            cfg.lr_match, max_y_diff=1.0, sad_max_distance=4000,
            sad_max_ratio=0.7, enable_robust_1to1_match=True,
            use_z_gate=True, min_z=2.0, max_z=25.0),
        if_match=dataclasses.replace(cfg.if_match, sad_max_distance=4000),
    )


class SyntheticSequence(NamedTuple):
    frames: list            # list of (left u8 [H,W], right u8 [H,W])
    rel_poses: np.ndarray   # [N-1, 4, 4] ground-truth T_{prev<-cur}
    poses: np.ndarray       # [N, 4, 4] camera-to-world
    cam: StereoCamera


def _rotmat(w):
    t = np.linalg.norm(w)
    if t < 1e-12:
        return np.eye(3)
    k = w / t
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * K @ K


def render_frame(pts_w, intens, sizes, T_wc, cam: StereoCamera, H, W,
                 rng=None):
    """Render left/right u8 images of the blob field from camera pose T_wc."""
    R = T_wc[:3, :3]
    t = T_wc[:3, 3]
    pts_c = (pts_w - t) @ R  # world -> camera

    fx, fy = float(cam.fx_l), float(cam.fy_l)
    cx, cy = float(cam.cx_l), float(cam.cy_l)
    b = float(cam.baseline)

    imgs = []
    WIN = 4  # blob half-window (pixels)
    for eye in (0, 1):
        img = np.full((H, W), 128.0, dtype=np.float32)
        P = pts_c.copy()
        P[:, 0] -= b if eye == 1 else 0.0
        vis = P[:, 2] > 0.5
        u = fx * (P[vis, 0] / P[vis, 2]) + cx
        v = fy * (P[vis, 1] / P[vis, 2]) + cy
        Z = P[:, 2]
        Ai = intens[vis]
        Pi = sizes[vis]  # [N,3]: sig_a, sig_b, theta
        inb = (u >= WIN + 1) & (u < W - WIN - 1) & (v >= WIN + 1) & (v < H - WIN - 1)
        u, v, Ai, Pi = u[inb], v[inb], Ai[inb], Pi[inb]
        # anti-aliased anisotropic Gaussian blobs at exact subpixel centers
        ub = np.floor(u).astype(np.int32)
        vb = np.floor(v).astype(np.int32)
        dyy, dxx = np.mgrid[-WIN: WIN + 1, -WIN: WIN + 1]
        gx = ub[:, None, None] + dxx[None]       # [N,9,9]
        gy = vb[:, None, None] + dyy[None]
        rx = gx - u[:, None, None]
        ry = gy - v[:, None, None]
        ct = np.cos(Pi[:, 2])[:, None, None]
        st = np.sin(Pi[:, 2])[:, None, None]
        ra = rx * ct + ry * st
        rb = -rx * st + ry * ct
        # metric blob size: the pixel footprint scales with fx/Z
        zf = (fx / Z[vis][inb])[:, None, None]
        sa = np.clip(Pi[:, 0][:, None, None] * zf, 0.55, 3.2)
        sb = np.clip(Pi[:, 1][:, None, None] * zf, 0.55, 3.2)
        fade = np.clip(Pi[:, 0][:, None, None] * zf / 0.55, None, 1.0) ** 2
        e = (ra / sa) ** 2 + (rb / sb) ** 2
        vals = fade * Ai[:, None, None] * np.exp(-0.5 * e)
        np.add.at(img, (gy.ravel(), gx.ravel()), vals.ravel())
        if rng is not None:   # mild noise so patches are not exactly flat
            img += rng.normal(0, 1.0, img.shape).astype(np.float32)
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
    return imgs[0], imgs[1]


def make_sequence(n_frames: int = 10, n_points: int = 900, H: int = 240,
                  W: int = 376, seed: int = 0, speed: float = 0.25,
                  yaw_rate: float = 0.004,
                  cam: StereoCamera | None = None) -> SyntheticSequence:
    """Forward motion with gentle yaw through a deep random blob field."""
    rng = np.random.default_rng(seed)
    if cam is None:
        cam = StereoCamera.make(fx_l=320.0, fy_l=320.0, cx_l=W / 2.0,
                                cy_l=H / 2.0, baseline=0.4)

    def trajectory():
        out, T = [], np.eye(4)
        for _ in range(n_frames):
            out.append(T.copy())
            step = np.eye(4)
            step[:3, :3] = _rotmat(np.array([0.0, yaw_rate, 0.0]))
            step[:3, 3] = np.array([0.0, 0.0, speed])
            T = T @ step
        return np.stack(out)

    # points populate a corridor along the trajectory: each anchors to a
    # random pose along the path plus a local offset
    poses = trajectory()
    anchors = poses[rng.integers(0, n_frames, n_points)]
    local = np.stack([
        rng.uniform(-18, 18, n_points),
        rng.uniform(-6, 6, n_points),
        rng.uniform(2.0, 45.0, n_points),
    ], axis=-1)
    pts = np.einsum("nij,nj->ni", anchors[:, :3, :3], local) + anchors[:, :3, 3]
    amp = rng.uniform(60, 127, n_points) * rng.choice([-1.0, 1.0], n_points)
    intens = amp.astype(np.float32)
    sizes = np.stack([
        rng.uniform(0.02, 0.12, n_points),
        rng.uniform(0.02, 0.12, n_points),
        rng.uniform(0, np.pi, n_points),
    ], axis=-1).astype(np.float32)

    frames = [render_frame(pts, intens, sizes, poses[i], cam, H, W, rng)
              for i in range(n_frames)]
    rel = [np.linalg.inv(poses[i - 1]) @ poses[i] for i in range(1, n_frames)]
    rel = np.stack(rel) if rel else np.zeros((0, 4, 4))
    return SyntheticSequence(frames=frames, rel_poses=rel, poses=poses,
                             cam=cam)
