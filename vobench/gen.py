"""The benchmark's scene generator: stereo blob fields rendered on the device.

A PyTorch rewrite of the blob-field renderer of rso_torch/synthetic.py
(anti-aliased anisotropic Gaussian blobs of metric size at exact subpixel
centres, mild pixel noise), made for long runs: the scene and the noise are
drawn from one `torch.Generator` on the device, frames are rendered in
batches, and the splat accumulates in fixed point, so a seed gives the same
frames on every run (float atomics would not).

A configuration's `lap` is a closed trajectory: its last frame steps back
onto its first, so the lap plays over and over without a seam.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BLOB_HALF = 4              # blob half-window in pixels, as the program's renderer
FIXED = 4096.0             # fixed-point scale of the splat
RENDER_BATCH = 16          # frames rendered a call


def _yaw_step(yaw: float, step_m: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    T[2, 3] = step_m
    return T


def lap_poses(lap: dict) -> np.ndarray:
    """[n, 4, 4] camera-to-world poses (float64) of a closed lap: forward
    `step_m` a frame with a constant yaw of 2*pi/n, a screw about a
    vertical axis whose n-th power is the identity. `bob_m` and
    `bob_cycles` add a vertical sine of that many whole cycles a lap."""
    n = int(lap["frames"])
    step = _yaw_step(2.0 * math.pi / n, float(lap["step_m"]))
    poses = np.empty((n, 4, 4))
    T = np.eye(4)
    for k in range(n):
        poses[k] = T
        T = T @ step
    bob, cycles = float(lap.get("bob_m", 0.0)), int(lap.get("bob_cycles", 0))
    if bob:
        poses[:, 1, 3] += bob * np.sin(2.0 * math.pi * cycles
                                       * np.arange(n) / n)
    return poses


class Eye:
    """One camera of the rig: left-camera coordinates -> this eye's pixels
    (pinhole, optional radial-tangential distortion [k1, k2, p1, p2, k3])."""

    def __init__(self, K, R=None, t=None, dist=None):
        self.K = np.asarray(K, np.float64)
        self.R = np.eye(3) if R is None else np.asarray(R, np.float64)
        self.t = np.zeros(3) if t is None else np.asarray(t, np.float64)
        self.dist = None if dist is None else np.asarray(dist, np.float64)


def distort(x, y, d):
    """Radial-tangential distortion of normalised coordinates (tensors)."""
    k1, k2, p1, p2, k3 = (float(v) for v in d)
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


class Scene:
    """A blob field along a lap, drawn from `gen`: each blob anchors to a
    random lap pose plus a local offset in that camera's frame."""

    def __init__(self, scene: dict, poses: np.ndarray, gen: torch.Generator,
                 device):
        n = int(scene["blobs"])
        dev = torch.device(device)

        def uni(lo, hi, size=(n,)):
            return lo + (hi - lo) * torch.rand(size, generator=gen,
                                               device=dev, dtype=torch.float64)

        P = torch.as_tensor(poses, device=dev)
        anchor = torch.randint(0, len(poses), (n,), generator=gen, device=dev)
        (x0, x1), (y0, y1), (z0, z1) = (scene["local_x"], scene["local_y"],
                                        scene["local_z"])
        local = torch.stack([uni(x0, x1), uni(y0, y1), uni(z0, z1)], -1)
        A = P[anchor]
        self.pts = _rotate(local, A[:, :3, :3]) + A[:, :3, 3]
        a0, a1 = scene["amplitude"]
        sign = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5,
                           -1.0, 1.0).to(torch.float64)
        self.amp = (uni(a0, a1) * sign).float()
        s0, s1 = scene["size_m"]
        self.sizes = torch.stack([uni(s0, s1), uni(s0, s1),
                                  uni(0.0, math.pi)], -1).float()
        self.noise = float(scene["noise"])


def _rotate(p: torch.Tensor, R: torch.Tensor, transpose: bool = False):
    """R @ p (R^T @ p with `transpose`) for points p [..., 3], in products
    and sums of a fixed order: a matrix product's order, and so its last
    bits, can change with the library's threads, and a bit can move a
    pixel."""
    if transpose:
        R = R.transpose(-1, -2)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([R[..., i, 0] * x + R[..., i, 1] * y + R[..., i, 2] * z
                        for i in range(3)], -1)


def render(scene: Scene, poses: np.ndarray, eyes: list, H: int, W: int,
           gen: torch.Generator) -> torch.Tensor:
    """uint8 [F, len(eyes), H, W] views of `scene` from camera-to-world
    `poses` [F, 4, 4], on the scene's device."""
    dev = scene.pts.device
    F, E = len(poses), len(eyes)
    T = torch.as_tensor(poses, device=dev)
    # world -> left camera: (p - t) @ R
    pc = _rotate(scene.pts[None] - T[:, None, :3, 3], T[:, None, :3, :3], True)
    r = torch.arange(-BLOB_HALF, BLOB_HALF + 1, device=dev)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    dx, dy = dx.reshape(-1).float(), dy.reshape(-1).float()
    acc = []
    for eye in eyes:
        P = _rotate(pc, torch.as_tensor(eye.R, device=dev)) \
            + torch.as_tensor(eye.t, device=dev)
        Z = P[..., 2]
        vis = Z > 0.5
        Zs = torch.where(vis, Z, torch.ones_like(Z))
        xn, yn = P[..., 0] / Zs, P[..., 1] / Zs
        if eye.dist is not None:
            xn, yn = distort(xn, yn, eye.dist)
        K = eye.K
        u = (K[0, 0] * xn + K[0, 2]).float()
        v = (K[1, 1] * yn + K[1, 2]).float()
        m = BLOB_HALF + 1
        inb = vis & (u >= m) & (u < W - m) & (v >= m) & (v < H - m)
        ub, vb = torch.floor(u), torch.floor(v)
        gx = ub[..., None] + dx                       # [F, N, 81]
        gy = vb[..., None] + dy
        rx, ry = gx - u[..., None], gy - v[..., None]
        ct = torch.cos(scene.sizes[:, 2])[None, :, None]
        st = torch.sin(scene.sizes[:, 2])[None, :, None]
        ra, rb = rx * ct + ry * st, -rx * st + ry * ct
        zf = (K[0, 0] / Zs).float()[..., None]
        sa = (scene.sizes[:, 0][None, :, None] * zf).clamp(0.55, 3.2)
        sb = (scene.sizes[:, 1][None, :, None] * zf).clamp(0.55, 3.2)
        fade = (scene.sizes[:, 0][None, :, None] * zf / 0.55).clamp(max=1.0) ** 2
        val = fade * scene.amp[None, :, None] * torch.exp(
            -0.5 * ((ra / sa) ** 2 + (rb / sb) ** 2))
        val = torch.where(inb[..., None], val, torch.zeros_like(val))
        idx = (gy.clamp(0, H - 1) * W + gx.clamp(0, W - 1)).long()
        idx = idx + (torch.arange(F, device=dev) * (H * W))[:, None, None]
        flat = torch.zeros(F * H * W, dtype=torch.int64, device=dev)
        flat.index_add_(0, idx.reshape(-1),
                        torch.round(val * FIXED).long().reshape(-1))
        acc.append(flat.view(F, H, W))
    img = 128.0 + torch.stack(acc, 1).double() / FIXED
    img = img + scene.noise * torch.randn((F, E, H, W), generator=gen,
                                          device=dev, dtype=torch.float64)
    return img.clamp(0, 255).floor().to(torch.uint8)


def render_lap(scene: Scene, poses: np.ndarray, eyes: list, H: int, W: int,
               gen: torch.Generator, out: torch.Tensor) -> torch.Tensor:
    """Render every pose into `out` [n, len(eyes), H, W] (any device, e.g.
    pinned host memory), RENDER_BATCH frames a call, in order."""
    for s in range(0, len(poses), RENDER_BATCH):
        out[s:s + RENDER_BATCH].copy_(
            render(scene, poses[s:s + RENDER_BATCH], eyes, H, W, gen))
    return out


def rig(cfg: dict) -> list:
    """The configuration's two eyes."""
    cam = cfg["camera"]
    if "K_l" not in cam:              # a rectified rig
        K = [[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]]
        return [Eye(K), Eye(K, t=[-cam["baseline_m"], 0.0, 0.0])]
    R_lr, t_lr = np.asarray(cam["R_lr"]), np.asarray(cam["t_lr"])
    # X_l = R_lr X_r + t_lr, so X_r = R_lr^T (X_l - t_lr)
    return [Eye(cam["K_l"], dist=cam["dist_l"]),
            Eye(cam["K_r"], R=R_lr.T, t=-R_lr.T @ t_lr, dist=cam["dist_r"])]


def make_lap(cfg: dict, seed: int, device, out: torch.Tensor) -> np.ndarray:
    """Draw the scene of `seed` and render the configuration's lap into
    `out` [n, 2, H, W] uint8. Returns the lap's poses [n, 4, 4]."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    poses = lap_poses(cfg["lap"])
    scene = Scene(cfg["scene"], poses, gen, device)
    H, W = cfg["camera"]["height"], cfg["camera"]["width"]
    render_lap(scene, poses, rig(cfg), H, W, gen, out)
    return poses
