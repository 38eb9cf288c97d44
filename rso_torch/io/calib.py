"""Calibration parsing + rectification map computation (host-side numpy).

A copy of rso/io/calib.py, which cannot be imported here because importing
any `rso` module loads jax.  It covers the reference's camera-calibration
inputs (an MRPT INI [CAMERA_PARAMS] section, demo-main.cpp:184-205) plus
KITTI odometry calib.txt and EuRoC sensor.yaml.  Rectification maps mirror
MRPT's CStereoRectifyMap (stage1_rectify.cpp:66-73): computed once on the
host, applied on the device by rso_torch.frontend.pyramid.bilinear_remap.
The cameras it returns are this package's StereoCamera, on the CPU.
"""
from __future__ import annotations

import configparser
from typing import NamedTuple

import numpy as np

from rso_torch.geometry.stereo_camera import StereoCamera


class FullCalibration(NamedTuple):
    """Intrinsics + distortion + extrinsics for an unrectified stereo pair."""

    K_l: np.ndarray        # [3,3]
    K_r: np.ndarray
    dist_l: np.ndarray     # [k1,k2,p1,p2,k3]
    dist_r: np.ndarray
    R_lr: np.ndarray       # [3,3] rotation right-cam wrt left-cam
    t_lr: np.ndarray       # [3]  translation right-cam wrt left-cam
    size: tuple            # (H, W)


def load_kitti_calib(path: str, cam_ids=(0, 1)) -> StereoCamera:
    """KITTI odometry calib.txt: P0..P3 3x4 projection matrices (already
    rectified).  Baseline = -P1[0,3]/fx."""
    Ps = {}
    with open(path) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                vals = np.array([float(x) for x in v.split()])
                if vals.size == 12:
                    Ps[k.strip()] = vals.reshape(3, 4)
    P_l = Ps[f"P{cam_ids[0]}"]
    P_r = Ps[f"P{cam_ids[1]}"]
    fx, fy = P_l[0, 0], P_l[1, 1]
    cx, cy = P_l[0, 2], P_l[1, 2]
    baseline = -(P_r[0, 3] - P_l[0, 3]) / fx
    return StereoCamera.make(fx_l=fx, fy_l=fy, cx_l=cx, cy_l=cy,
                             baseline=baseline,
                             fx_r=P_r[0, 0], fy_r=P_r[1, 1],
                             cx_r=P_r[0, 2], cy_r=P_r[1, 2])


def load_mrpt_ini_calib(path: str, section: str = "CAMERA_PARAMS") -> StereoCamera:
    """MRPT-style INI stereo calibration (the reference demo's --cam input:
    cam_matrix / rightCameraPose entries, demo-main.cpp:184-196)."""
    p = configparser.ConfigParser(inline_comment_prefixes=("//", ";", "#"))
    p.optionxform = str
    p.read(path)
    s = p[section]

    def vec(key):
        return np.array([float(x) for x in s[key].replace("[", "").replace("]", "").split()])

    # MRPT TStereoCamera INI keys
    res = vec("resolution").astype(int) if "resolution" in s else None
    cl = vec("cam0_intrinsic") if "cam0_intrinsic" in s else None
    if cl is not None:
        fx, fy, cx, cy = cl[:4]
    else:
        fx, fy = float(s["fx"]), float(s["fy"])
        cx, cy = float(s["cx"]), float(s["cy"])
    baseline = float(s.get("baseline", 0.12))
    return StereoCamera.make(fx_l=fx, fy_l=fy, cx_l=cx, cy_l=cy, baseline=baseline)


def load_euroc_calib(left_yaml: str, right_yaml: str) -> FullCalibration:
    """EuRoC MAV sensor.yaml pair (simple line parser, no yaml dependency)."""

    def parse(path):
        vals = {}
        key = None
        with open(path) as f:
            txt = f.read()
        import re

        m = re.search(r"T_BS.*?data:\s*\[(.*?)\]", txt, re.S)
        T = np.array([float(x) for x in m.group(1).split(",")]).reshape(4, 4)
        m = re.search(r"intrinsics:\s*\[(.*?)\]", txt)
        intr = np.array([float(x) for x in m.group(1).split(",")])
        m = re.search(r"distortion_coefficients:\s*\[(.*?)\]", txt)
        dist = np.array([float(x) for x in m.group(1).split(",")])
        m = re.search(r"resolution:\s*\[(.*?)\]", txt)
        res = [int(float(x)) for x in m.group(1).split(",")]
        return T, intr, dist, res

    T_l, intr_l, dist_l, res = parse(left_yaml)
    T_r, intr_r, dist_r, _ = parse(right_yaml)
    K_l = np.array([[intr_l[0], 0, intr_l[2]], [0, intr_l[1], intr_l[3]], [0, 0, 1.0]])
    K_r = np.array([[intr_r[0], 0, intr_r[2]], [0, intr_r[1], intr_r[3]], [0, 0, 1.0]])
    T_rl = np.linalg.inv(T_r) @ T_l          # left-cam coords -> right-cam coords
    R = np.linalg.inv(T_rl[:3, :3])          # right wrt left
    t = -R @ T_rl[:3, 3]
    d_l = np.concatenate([dist_l, np.zeros(5 - len(dist_l))])
    d_r = np.concatenate([dist_r, np.zeros(5 - len(dist_r))])
    return FullCalibration(K_l=K_l, K_r=K_r, dist_l=d_l, dist_r=d_r,
                           R_lr=R, t_lr=t, size=(res[1], res[0]))


# ---------------------------------------------------------------------------
# Rectification (fishless pinhole + plumb-bob): host-side map computation
# ---------------------------------------------------------------------------


def _distort(pts, dist):
    """Apply plumb-bob distortion to normalized coords [N,2]."""
    k1, k2, p1, p2, k3 = dist
    x, y = pts[:, 0], pts[:, 1]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def compute_rectify_maps(calib: FullCalibration):
    """Stereo rectification a la Bouguet/OpenCV stereoRectify + initUndistortRectifyMap.

    Returns (cam, (map_lx, map_ly), (map_rx, map_ry)): the rectified
    StereoCamera and per-eye float32 sample maps (same shape as the image)
    to feed bilinear_remap.
    """
    H, W = calib.size
    R, t = calib.R_lr, calib.t_lr

    # split the relative rotation between the two eyes
    from scipy.spatial.transform import Rotation as Rot

    r = Rot.from_matrix(R).as_rotvec()
    R_half_l = Rot.from_rotvec(r / 2).as_matrix()
    R_half_r = Rot.from_rotvec(-r / 2).as_matrix()

    # new x-axis along the baseline
    t_rect = R_half_r @ t  # baseline in the intermediate frame
    e1 = t_rect / np.linalg.norm(t_rect)
    if e1[0] < 0:
        e1 = -e1
    e2 = np.cross(np.array([0.0, 0.0, 1.0]), e1)
    e2 /= np.linalg.norm(e2)
    e3 = np.cross(e1, e2)
    R_align = np.stack([e1, e2, e3])

    # (R_rect_x maps old-cam coords -> rectified coords)
    # With X_l = R_lr X_r + t_lr and R_h = exp(r/2) (R_lr = R_h R_h):
    #   R_rect_l = R_align R_h^T,  R_rect_r = R_rect_l R_lr = R_align R_h
    # so both new frames differ only by translation along the new x axis.
    R_rect_l = R_align @ R_half_r        # R_half_r == R_h^T
    R_rect_r = R_align @ R_half_l        # R_half_l == R_h

    # shared rectified intrinsics
    f = (calib.K_l[0, 0] + calib.K_l[1, 1] + calib.K_r[0, 0] + calib.K_r[1, 1]) / 4
    cx, cy = (W - 1) / 2, (H - 1) / 2
    baseline = np.linalg.norm(t)

    cam = StereoCamera.make(fx_l=f, fy_l=f, cx_l=cx, cy_l=cy, baseline=baseline)

    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    pix = np.stack([xs.ravel(), ys.ravel(), np.ones(H * W)], axis=-1)

    maps = []
    for K, dist, R_rect in ((calib.K_l, calib.dist_l, R_rect_l),
                            (calib.K_r, calib.dist_r, R_rect_r)):
        # rectified pixel -> rectified ray -> original cam ray -> distort -> src pixel
        rays = pix @ np.linalg.inv(
            np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])).T
        rays = rays @ R_rect  # R_rect^T applied to rows: rectified -> original
        norm = rays[:, :2] / rays[:, 2:3]
        dd = _distort(norm, dist)
        u = K[0, 0] * dd[:, 0] + K[0, 2]
        v = K[1, 1] * dd[:, 1] + K[1, 2]
        maps.append((u.reshape(H, W).astype(np.float32),
                     v.reshape(H, W).astype(np.float32)))
    return cam, maps[0], maps[1]
