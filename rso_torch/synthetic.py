"""Synthetic stereo sequences with exact ground truth (host numpy).

A copy of `make_sequence`, `make_unrectified_sequence`, `render_frame` and
`synthetic_config` (the blob field), and of `default_texture`,
`render_textured_frame`, `make_textured_sequence` and `textured_config`
(the textured corridor, the scene the presets' refine and robust 1-to-1
arbitration were tuned on) from rso/synthetic.py, which cannot be imported
here because it loads jax.  Same seed, same numpy calls in the same order,
so the same arguments give the same frames (and calibration) as the
reference's generator.

`mode_config` adds the detector / matcher / tracker combinations that
tests/test_modes.py runs on the blob scene, so that tests and chip_smoke.py
drive the same configurations.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from rso_torch.config import (
    DetectMethod,
    IFMatchMethod,
    NMSMethod,
    RSOConfig,
    StereoMatchMethod,
)
from rso_torch.geometry.stereo_camera import StereoCamera
from rso_torch.io.calib import FullCalibration, _distort


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


MODES = ("fast_orb_rbr_win", "orb_bf_bf", "klt_sad_sad", "sad_dense",
         "adaptive_nms")


def mode_config(mode: str, upright: bool = True) -> RSOConfig:
    """synthetic_config() switched to one of MODES, with the settings of
    tests/test_modes.py `TestDetectorModes` (descriptor distance 64,
    1.5 px rows, no z-gate):

      fast_orb_rbr_win  FAST_ORB + stereo DESC_RBR + tracking DESC_WIN
      orb_bf_bf         ORB (one octave, 8 internal levels) + DESC_BF + DESC_BF
      klt_sad_sad       KLT (minimum response 5) + SAD + SAD
      sad_dense         the default modes on the dense SAD matrices
                        (use_fused_match=False)
      adaptive_nms      the default modes with adaptive NMS

    `upright` sets orb_upright for the two descriptor modes."""
    cfg = synthetic_config()
    rep = dataclasses.replace
    if mode in ("fast_orb_rbr_win", "orb_bf_bf"):
        fast_orb = mode == "fast_orb_rbr_win"
        return cfg.replace(
            detect=rep(cfg.detect, orb_upright=upright, detect_method=(
                DetectMethod.FAST_ORB if fast_orb else DetectMethod.ORB)),
            lr_match=rep(cfg.lr_match, orb_max_distance=64.0, max_y_diff=1.5,
                         use_z_gate=False, match_method=(
                             StereoMatchMethod.DESC_RBR if fast_orb
                             else StereoMatchMethod.DESC_BF)),
            if_match=rep(cfg.if_match, orb_max_distance=64.0, ifm_method=(
                IFMatchMethod.DESC_WIN if fast_orb else IFMatchMethod.DESC_BF)))
    if mode == "klt_sad_sad":
        return cfg.replace(detect=rep(cfg.detect,
                                      detect_method=DetectMethod.KLT,
                                      minimum_KLT_response=5.0))
    if mode == "sad_dense":
        return cfg.replace(tpu=rep(cfg.tpu, use_fused_match=False))
    if mode == "adaptive_nms":
        return cfg.replace(detect=rep(cfg.detect, nmsMethod=NMSMethod.ADAPTIVE))
    raise ValueError(f"unknown mode {mode!r}; one of {MODES}")


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
                 rng=None, dist=None, R_lr=None):
    """Render left/right u8 images of the blob field from camera pose T_wc.

    dist: optional plumb-bob coefficients [k1,k2,p1,p2,k3] applied to both
    eyes (an unrectified rig); R_lr: optional 3x3 rotation of the right
    camera wrt the left (rig misalignment)."""
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
        if eye == 1 and R_lr is not None:
            P = P @ R_lr  # right-camera frame rotated wrt left: R_lr^T P
        vis = P[:, 2] > 0.5
        xn = P[vis, 0] / P[vis, 2]
        yn = P[vis, 1] / P[vis, 2]
        if dist is not None:
            d = _distort(np.stack([xn, yn], -1), dist)
            xn, yn = d[:, 0], d[:, 1]
        u = fx * xn + cx
        v = fy * yn + cy
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


def make_unrectified_sequence(n_frames=8, n_points=1500, H=240, W=376,
                              seed=0, speed=0.25,
                              dist=(-0.12, 0.04, 0.0005, -0.0005, 0.0),
                              rig_rot=(0.0, 0.006, 0.003)):
    """Synthetic sequence from a distorted, slightly misaligned rig, plus
    its FullCalibration: the input of the rectification path
    (io.calib.compute_rectify_maps + Engine(rectify_maps=...))."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    fx = 320.0
    cam = StereoCamera.make(fx_l=fx, fy_l=fx, cx_l=W / 2.0, cy_l=H / 2.0,
                            baseline=0.4)
    R_lr = Rotation.from_rotvec(np.asarray(rig_rot)).as_matrix()
    dist = np.asarray(dist, np.float64)

    pts = np.stack([
        rng.uniform(-18, 18, n_points),
        rng.uniform(-6, 6, n_points),
        rng.uniform(2.0, 45.0, n_points),
    ], axis=-1)
    amp = rng.uniform(60, 127, n_points) * rng.choice([-1.0, 1.0], n_points)
    sizes = np.stack([
        rng.uniform(0.02, 0.12, n_points),
        rng.uniform(0.02, 0.12, n_points),
        rng.uniform(0, np.pi, n_points),
    ], axis=-1).astype(np.float32)

    poses = []
    T = np.eye(4)
    for _ in range(n_frames):
        poses.append(T.copy())
        step = np.eye(4)
        step[:3, 3] = np.array([0.0, 0.0, speed])
        T = T @ step
    poses = np.stack(poses)
    frames = [render_frame(pts, amp.astype(np.float32), sizes, poses[i], cam,
                           H, W, rng, dist=dist, R_lr=R_lr)
              for i in range(n_frames)]
    rel = [np.linalg.inv(poses[i - 1]) @ poses[i] for i in range(1, n_frames)]
    rel = np.stack(rel) if rel else np.zeros((0, 4, 4))

    K = np.array([[fx, 0, W / 2.0], [0, fx, H / 2.0], [0, 0, 1.0]])
    calib = FullCalibration(
        K_l=K, K_r=K, dist_l=dist, dist_r=dist,
        R_lr=R_lr, t_lr=np.array([0.4, 0.0, 0.0]), size=(H, W))
    seq = SyntheticSequence(frames=frames, rel_poses=rel, poses=poses,
                            cam=cam)
    return seq, calib


# the photographic texture the reference's generator takes when the file
# exists (the same path as rso/synthetic.py's); else both packages take the
# procedural texture
_REFERENCE_TEXTURE = "/root/reference/libstereo-odometry/tests/0L.png"


def default_texture(size: int = 512, seed: int = 0) -> np.ndarray:
    """A texture for the corridor renderer: the reference repo's real test
    image when present (real photographic texture), else procedural
    multi-octave noise (still gradient-rich, unlike Gaussian blobs)."""
    import os

    if os.path.exists(_REFERENCE_TEXTURE):
        try:
            try:
                import cv2

                tex = cv2.imread(_REFERENCE_TEXTURE, cv2.IMREAD_GRAYSCALE)
            except ImportError:
                from PIL import Image

                tex = np.asarray(Image.open(_REFERENCE_TEXTURE).convert("L"))
            if tex is not None:
                # crop the black rectification-fill borders so they don't
                # tile into the corridor as textureless voids
                h, w = tex.shape
                return tex[int(0.12 * h):int(0.88 * h),
                           int(0.08 * w):int(0.92 * w)]
        except OSError:
            pass
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    for octv in (4, 8, 16, 32, 64):
        g = rng.normal(0, 1, (octv, octv)).astype(np.float32)
        # bilinear upsample the octave to full size (tileable via wrap)
        yy = np.linspace(0, octv, size, endpoint=False)
        xx = np.linspace(0, octv, size, endpoint=False)
        y0 = np.floor(yy).astype(int); x0 = np.floor(xx).astype(int)
        fy = (yy - y0)[:, None]; fx = (xx - x0)[None, :]
        y1 = (y0 + 1) % octv; x1 = (x0 + 1) % octv
        up = (g[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
              + g[np.ix_(y0, x1)] * (1 - fy) * fx
              + g[np.ix_(y1, x0)] * fy * (1 - fx)
              + g[np.ix_(y1, x1)] * fy * fx)
        tex += up * (64.0 / octv ** 0.5)
    tex = 128 + 64 * tex / np.abs(tex).max() * 2
    return np.clip(tex, 0, 255).astype(np.uint8)


def _sample_texture(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear sample a tiled texture at continuous (u,v) pixel coords."""
    TH, TW = tex.shape
    u = np.mod(u, TW); v = np.mod(v, TH)
    x0 = np.floor(u).astype(np.int64); y0 = np.floor(v).astype(np.int64)
    fx = (u - x0); fy = (v - y0)
    x1 = (x0 + 1) % TW; y1 = (y0 + 1) % TH
    t = tex.astype(np.float32)
    return (t[y0, x0] * (1 - fy) * (1 - fx) + t[y0, x1] * (1 - fy) * fx
            + t[y1, x0] * fy * (1 - fx) + t[y1, x1] * fy * fx)


def render_textured_frame(tex, T_wc, cam: StereoCamera, H, W,
                          corridor=(4.0, 2.0), px_per_m=48.0,
                          z_end=1e9, rng=None, supersample=2):
    """Ray-cast left/right u8 views of a texture-mapped corridor.

    The world is a corridor along +z: walls at x=+-corridor[0], floor and
    ceiling at y=+-corridor[1], an end-cap at z=z_end, every surface textured
    with `tex` at px_per_m texture pixels per meter.  Unlike the blob field,
    this produces dense photographic gradients — real-texture statistics for
    the detector, descriptors, and SAD matching.  Rendered at `supersample`x
    and box-downsampled (anti-aliasing at grazing angles).
    """
    a, b = corridor
    fx, fy = float(cam.fx_l), float(cam.fy_l)
    cx, cy = float(cam.cx_l), float(cam.cy_l)
    bl = float(cam.baseline)
    R = T_wc[:3, :3]
    t = T_wc[:3, 3]

    s = supersample
    Hs, Ws = H * s, W * s
    ys, xs = np.mgrid[0:Hs, 0:Ws].astype(np.float64)
    # supersampled pixel centers map to original pixel coords (x+0.5)/s - 0.5
    xn = ((xs + 0.5) / s - 0.5 - cx) / fx
    yn = ((ys + 0.5) / s - 0.5 - cy) / fy
    d_cam = np.stack([xn, yn, np.ones_like(xn)], axis=-1)   # [Hs,Ws,3]
    d = d_cam @ R.T                                         # world dirs

    out = []
    for eye in (0, 1):
        o = t + R @ np.array([bl * eye, 0.0, 0.0])
        best_t = np.full((Hs, Ws), np.inf)
        img = np.zeros((Hs, Ws), np.float32)
        # (axis, plane value, uv axes, shade): walls use (z,y), floor/ceiling
        # (z,x), end-cap (x,y); per-plane shade adds large-scale contrast
        planes = [(0, +a, (2, 1), 1.00), (0, -a, (2, 1), 0.85),
                  (1, +b, (2, 0), 0.70), (1, -b, (2, 0), 0.55),
                  (2, z_end, (0, 1), 0.80)]
        for axis, val, (ua, va), shade in planes:
            da = d[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                ti = (val - o[axis]) / da
            hit = np.isfinite(ti) & (ti > 0.05) & (ti < best_t)
            if not hit.any():
                continue
            p = o[None, :] + ti[hit][:, None] * d[hit]
            u = p[:, ua] * px_per_m
            v = p[:, va] * px_per_m
            img[hit] = _sample_texture(tex, u, v) * shade
            best_t[hit] = ti[hit]
        # box-downsample the supersampled render
        img = img.reshape(H, s, W, s).mean(axis=(1, 3))
        if rng is not None:
            img += rng.normal(0, 1.0, img.shape).astype(np.float32)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out[0], out[1]


def make_textured_sequence(
    texture: np.ndarray | None = None,
    n_frames: int = 10,
    H: int = 240,
    W: int = 376,
    seed: int = 0,
    speed: float = 0.25,
    yaw_rate: float = 0.004,
    cam: StereoCamera | None = None,
    corridor=(4.0, 2.0),
    px_per_m: float = 48.0,
) -> SyntheticSequence:
    """Forward motion with gentle yaw through a texture-mapped corridor.

    Same trajectory model as make_sequence but with photographic surface
    texture instead of Gaussian blobs — the real-imagery regression scene
    (detector/descriptor/SAD statistics match real images much more closely).
    """
    rng = np.random.default_rng(seed)
    if texture is None:
        texture = default_texture(seed=seed)
    if cam is None:
        cam = StereoCamera.make(fx_l=320.0, fy_l=320.0, cx_l=W / 2.0,
                                cy_l=H / 2.0, baseline=0.4)
    poses = []
    T = np.eye(4)
    for _ in range(n_frames):
        poses.append(T.copy())
        step = np.eye(4)
        step[:3, :3] = _rotmat(np.array([0.0, yaw_rate, 0.0]))
        step[:3, 3] = np.array([0.0, 0.0, speed])
        T = T @ step
    poses = np.stack(poses)
    z_end = n_frames * speed + 25.0
    frames = [render_textured_frame(texture, poses[i], cam, H, W,
                                    corridor=corridor, px_per_m=px_per_m,
                                    z_end=z_end, rng=rng)
              for i in range(n_frames)]
    rel = [np.linalg.inv(poses[i - 1]) @ poses[i] for i in range(1, n_frames)]
    rel = np.stack(rel) if rel else np.zeros((0, 4, 4))
    return SyntheticSequence(frames=frames, rel_poses=rel, poses=poses,
                             cam=cam)


def textured_config() -> RSOConfig:
    """RSOConfig tuned for the textured corridor scenes: real-texture SAD
    levels (a good 8x8 match sits ~300-500, computeSAD8_unittest.cpp:28)
    with an epipolar row tolerance for subpixel detections."""
    cfg = RSOConfig()
    return cfg.replace(
        lr_match=dataclasses.replace(
            cfg.lr_match, max_y_diff=1.0, sad_max_distance=1500,
            sad_max_ratio=0.7, enable_robust_1to1_match=True),
        if_match=dataclasses.replace(cfg.if_match, sad_max_distance=1500),
    )
