"""The plain reference of one stereo VO step, for the comparison that
decides `correct`.

Plain PyTorch and NumPy; it imports nothing of the program and takes
nothing the program made. From the raw frames of two consecutive stereo
pairs it works out again what the program derives: rectification maps
from the calibration (Bouguet's split of the rig rotation, the convention
the configurations state), corners (Shi-Tomasi minimum eigenvalue with
non-maximum suppression), stereo matches along rectified rows (SAD, ratio
test, parabola subpixel), triangulated landmarks, tracks into the next
left image (SAD over the configuration's search window), and the motion
(robust Gauss-Newton on reprojection, outliers cut, from the identity).

`dtype` sets the arithmetic: float64 for the reference, bfloat16 for the
lower-precision control (the 6x6 solve then rounds its float32 answer to
bfloat16, as no solver takes bfloat16).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as tnf

PATCH = 4             # SAD patch half-width: 9x9
CORNERS = 1000        # corners a frame
NMS = 7               # non-maximum suppression window
MIN_LANDMARKS = 20    # fewer inliers than this: the step is not valid


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float


class Step(NamedTuple):
    T: np.ndarray        # [4,4] T_{prev<-cur}: current camera in the previous
    valid: bool
    points: np.ndarray   # [n,3] inlier landmarks in the previous camera
    n_tracks: int


# ---- rectification ---------------------------------------------------------

def _rotvec_to_matrix(r: np.ndarray) -> np.ndarray:
    t = float(np.linalg.norm(r))
    if t < 1e-15:
        return np.eye(3)
    k = r / t
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(t) * K + (1 - math.cos(t)) * K @ K


def _matrix_to_rotvec(R: np.ndarray) -> np.ndarray:
    c = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    t = math.acos(c)
    if t < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * t / (2 * math.sin(t))


def _distort(x, y, d):
    k1, k2, p1, p2, k3 = d
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    return (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
            y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)


def rectification(cam: dict):
    """(Camera, R_rect_l, (map_l, map_r)) of an unrectified rig: the rig
    rotation split in halves between the eyes, the new x axis along the
    baseline, one focal length (the mean of the four) and the image centre;
    each map [H, W, 2] gives the source pixel (x, y) of a rectified pixel.
    R_rect_l takes left-camera coordinates to rectified ones."""
    H, W = cam["height"], cam["width"]
    Kl, Kr = np.asarray(cam["K_l"], float), np.asarray(cam["K_r"], float)
    R, t = np.asarray(cam["R_lr"], float), np.asarray(cam["t_lr"], float)
    r = _matrix_to_rotvec(R)
    half_l, half_r = _rotvec_to_matrix(r / 2), _rotvec_to_matrix(-r / 2)
    e1 = half_r @ t
    e1 = e1 / np.linalg.norm(e1)
    if e1[0] < 0:
        e1 = -e1
    e2 = np.cross([0.0, 0.0, 1.0], e1)
    e2 /= np.linalg.norm(e2)
    R_align = np.stack([e1, e2, np.cross(e1, e2)])
    R_l, R_r = R_align @ half_r, R_align @ half_l
    f = (Kl[0, 0] + Kl[1, 1] + Kr[0, 0] + Kr[1, 1]) / 4
    cx, cy = (W - 1) / 2, (H - 1) / 2
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    maps = []
    for K, d, Rr in ((Kl, cam["dist_l"], R_l), (Kr, cam["dist_r"], R_r)):
        rays = np.stack([(xs - cx) / f, (ys - cy) / f, np.ones_like(xs)], -1)
        rays = rays @ Rr                       # rectified -> this eye
        x, y = _distort(rays[..., 0] / rays[..., 2],
                        rays[..., 1] / rays[..., 2], np.asarray(d, float))
        maps.append(np.stack([K[0, 0] * x + K[0, 2], K[1, 1] * y + K[1, 2]], -1))
    return Camera(f, f, cx, cy, float(np.linalg.norm(t))), R_l, maps


def remap(img: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img [H,W] at m [H,W,2] (x, y); outside is NaN."""
    H, W = img.shape
    x, y = m[..., 0], m[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    inside = (x0 >= 0) & (y0 >= 0) & (x0 <= W - 2) & (y0 <= H - 2)
    xi = x0.clamp(0, W - 2).long()
    yi = y0.clamp(0, H - 2).long()
    a = img[yi, xi]
    b = img[yi, xi + 1]
    c = img[yi + 1, xi]
    d = img[yi + 1, xi + 1]
    out = (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
           + c * (1 - fx) * fy + d * fx * fy)
    return torch.where(inside, out, torch.full_like(out, float("nan")))


# ---- image stages ----------------------------------------------------------

def corners(img: torch.Tensor, n: int, margin: int) -> torch.Tensor:
    """[k,2] long (x, y) of the n strongest local maxima of the minimum
    eigenvalue of the 5x5 structure tensor, `margin` px from the edges and
    from any pixel that is not image (NaN)."""
    H, W = img.shape
    bad = torch.isnan(img)
    x = torch.nan_to_num(img, nan=0.0)[None, None]
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=img.dtype,
                      device=img.device)[None, None] / 8
    gx = tnf.conv2d(x, kx, padding=1)
    gy = tnf.conv2d(x, kx.transpose(2, 3), padding=1)
    box = lambda t: tnf.avg_pool2d(t, 5, 1, 2)  # noqa: E731
    sxx, syy, sxy = box(gx * gx), box(gy * gy), box(gx * gy)
    lam = 0.5 * (sxx + syy - torch.sqrt((sxx - syy) ** 2 + 4 * sxy * sxy))
    keep = lam == tnf.max_pool2d(lam, NMS, 1, NMS // 2)
    near_bad = tnf.max_pool2d(bad[None, None].float(), 2 * margin + 1, 1,
                              margin) > 0
    keep = keep & ~near_bad & (lam > 0)
    keep[..., :margin, :] = False
    keep[..., H - margin:, :] = False
    keep[..., :, :margin] = False
    keep[..., :, W - margin:] = False
    score = torch.where(keep, lam, torch.full_like(lam, -1.0))[0, 0].reshape(-1)
    k = min(n, int(keep.sum()))
    idx = torch.topk(score.float(), k).indices
    return torch.stack([idx % W, idx // W], -1)


def _offsets(r: int, device):
    g = torch.arange(-r, r + 1, device=device)
    dy, dx = torch.meshgrid(g, g, indexing="ij")
    return dx.reshape(-1), dy.reshape(-1)


def _padded(img: torch.Tensor, pad: int, fill: float = 1e3):
    return tnf.pad(torch.nan_to_num(img, nan=fill)[None, None],
                   (pad, pad, pad, pad), value=fill)[0, 0]


def _subpixel(sm, s0, sp):
    den = sm - 2 * s0 + sp
    off = torch.where(den > 0, 0.5 * (sm - sp) / den.clamp(min=1e-6),
                      torch.zeros_like(s0))
    return off.clamp(-0.5, 0.5)


def stereo(left: torch.Tensor, right: torch.Tensor, xy: torch.Tensor,
           max_disp: int, ratio: float, max_mad: float):
    """Disparity (subpixel) of each left corner along its row of the right
    image, and whether the match holds (ratio test, mean absolute
    difference under max_mad)."""
    r = PATCH
    pad = max_disp + r + 2
    L, R = _padded(left, pad), _padded(right, pad)
    ox, oy = _offsets(r, left.device)
    x, y = xy[:, 0] + pad, xy[:, 1] + pad
    tmpl = L[y[:, None] + oy, x[:, None] + ox]                       # [N,81]
    d = torch.arange(0, max_disp + 1, device=left.device)
    cand = R[(y[:, None, None] + oy), (x[:, None, None] - d[None, :, None] + ox)]
    sad = (cand - tmpl[:, None]).abs().sum(-1)                        # [N,D]
    sad[:, 0] = float("inf")
    best, arg = sad.min(1)
    near = (d[None] - arg[:, None]).abs() <= 1
    second = torch.where(near, torch.full_like(sad, float("inf")), sad).min(1).values
    ok = (best < ratio * second) & (best < max_mad * tmpl.shape[1]) \
        & (arg >= 1) & (arg < max_disp)
    a = arg.clamp(1, max_disp - 1)
    g = lambda k: sad.gather(1, (a + k)[:, None])[:, 0]  # noqa: E731
    disp = a.to(left.dtype) + _subpixel(g(-1), g(0), g(1))
    return disp, ok


def track(prev: torch.Tensor, cur: torch.Tensor, xy: torch.Tensor,
          half_win: int, ratio: float, max_mad: float):
    """Position (subpixel) in `cur` of each `prev` corner: the least SAD of
    its patch within +-half_win px, with a ratio test against the best
    outside its 3x3 neighbourhood."""
    r, w = PATCH, half_win
    pad = w + r + 2
    P, C = _padded(prev, pad), _padded(cur, pad)
    ox, oy = _offsets(r, prev.device)
    x, y = xy[:, 0] + pad, xy[:, 1] + pad
    tmpl = P[y[:, None] + oy, x[:, None] + ox]                       # [N,81]
    side = 2 * w + 1
    # each corner's search region, every patch pixel of every shift
    g = torch.arange(-(w + r), w + r + 1, device=prev.device)
    region = C[(y[:, None] + g)[:, :, None], (x[:, None] + g)[:, None, :]]
    S = torch.zeros((len(xy), side, side), dtype=prev.dtype,
                    device=prev.device)
    for k in range(ox.numel()):          # patch pixel k = (dy, dx), as in tmpl
        dy, dx = divmod(k, 2 * r + 1)
        win = region[:, dy:dy + side, dx:dx + side]
        S += (win - tmpl[:, k, None, None]).abs_()
    sad = S.view(len(xy), -1)            # shifts (dy, dx) row by row
    sx, sy = _offsets(w, prev.device)
    best, arg = sad.min(1)
    ax, ay = arg % side, arg // side
    grid_x, grid_y = sx + w, sy + w
    near = ((grid_x[None] - ax[:, None]).abs() <= 1) \
        & ((grid_y[None] - ay[:, None]).abs() <= 1)
    second = torch.where(near, torch.full_like(sad, float("inf")), sad).min(1).values
    ok = (best < ratio * second) & (best < max_mad * tmpl.shape[1]) \
        & (ax >= 1) & (ax < side - 1) & (ay >= 1) & (ay < side - 1)
    axc, ayc = ax.clamp(1, side - 2), ay.clamp(1, side - 2)
    rows = torch.arange(len(S), device=S.device)
    at = lambda dy, dx: S[rows, ayc + dy, axc + dx]  # noqa: E731
    u = xy[:, 0].to(prev.dtype) + (axc - w).to(prev.dtype) \
        + _subpixel(at(0, -1), at(0, 0), at(0, 1))
    v = xy[:, 1].to(prev.dtype) + (ayc - w).to(prev.dtype) \
        + _subpixel(at(-1, 0), at(0, 0), at(1, 0))
    return torch.stack([u, v], -1), ok


# ---- motion ----------------------------------------------------------------

def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _exp(w):
    t = torch.sqrt((w * w).sum())
    K = _hat(w / t.clamp(min=1e-12))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(t) * K + (1 - torch.cos(t)) * (K @ K)


def motion(X: torch.Tensor, uv: torch.Tensor, cam: Camera, dtype):
    """R, t with uv ~ pi(R X + t), robust Gauss-Newton from the identity:
    12 Huber iterations (3 px), then 8 on the residuals under 2 px.
    Returns (R, t, inlier mask)."""
    R = torch.eye(3, dtype=dtype, device=X.device)
    t = torch.zeros(3, dtype=dtype, device=X.device)
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    w_in = torch.ones(len(X), dtype=torch.bool, device=X.device)

    def residual(R, t):
        P = X @ R.T + t
        z = P[:, 2]
        r = torch.stack([fx * P[:, 0] / z + cx - uv[:, 0],
                         fy * P[:, 1] / z + cy - uv[:, 1]], -1)
        return P, z, r

    for it in range(20):
        P, z, r = residual(R, t)
        e = torch.sqrt((r * r).sum(-1))
        if it < 12:
            w = torch.where(e <= 3.0, torch.ones_like(e), 3.0 / e.clamp(min=1e-9))
        else:
            if it == 12:
                w_in = e < 2.0
            w = w_in.to(dtype)
        w = torch.where(z > 0.1, w, torch.zeros_like(w))
        zi = 1.0 / z.clamp(min=0.1)
        Ju = torch.stack([fx * zi, torch.zeros_like(zi), -fx * P[:, 0] * zi * zi], -1)
        Jv = torch.stack([torch.zeros_like(zi), fy * zi, -fy * P[:, 1] * zi * zi], -1)
        # d(P)/d(omega) = -[P]x, d(P)/d(nu) = I (left increment)
        Px = -_hat(P)
        J = torch.cat([torch.stack([Ju[:, None] @ Px, Jv[:, None] @ Px], 1)[:, :, 0],
                       torch.stack([Ju, Jv], 1)], -1)                # [N,2,6]
        Hm = torch.einsum("n,nki,nkj->ij", w, J, J).double()
        g = torch.einsum("n,nki,nk->i", w, J, r).double()
        damp = 1e-9 * (1.0 + torch.diagonal(Hm).sum())
        sol, info = torch.linalg.solve_ex(
            Hm + damp * torch.eye(6, device=X.device, dtype=torch.float64), -g)
        if int(info) != 0 or not bool(torch.isfinite(sol).all()):
            return R, t, torch.zeros_like(w_in)
        sol = sol.to(dtype)
        dR = _exp(sol[:3])
        R, t = dR @ R, dR @ t + sol[3:]
    _, z, r = residual(R, t)
    inl = (torch.sqrt((r * r).sum(-1)) < 2.0) & (z > 0.1)
    return R, t, inl


def step(prev_l, prev_r, cur_l, cam: Camera, params: dict, dtype) -> Step:
    """The reference's motion between two stereo pairs (rectified images as
    [H,W] tensors of `dtype`)."""
    xy = corners(prev_l, CORNERS, margin=PATCH + 2)
    disp, ok_s = stereo(prev_l, prev_r, xy, params["max_disp"],
                        params["ratio"], params["max_mad"])
    uv, ok_t = track(prev_l, cur_l, xy, params["half_win"], params["ratio"],
                     params["max_mad"])
    ok = ok_s & ok_t
    xy, disp, uv = xy[ok].to(dtype), disp[ok], uv[ok]
    Z = cam.fx * cam.baseline / disp
    X = torch.stack([(xy[:, 0] - cam.cx) * Z / cam.fx,
                     (xy[:, 1] - cam.cy) * Z / cam.fy, Z], -1)
    if len(X) < MIN_LANDMARKS:
        return Step(np.eye(4), False, np.zeros((0, 3)), len(X))
    R, t, inl = motion(X, uv, cam, dtype)
    M = np.eye(4)
    M[:3, :3] = R.double().cpu().numpy()
    M[:3, 3] = t.double().cpu().numpy()
    n_in = int(inl.sum())
    return Step(np.linalg.inv(M), n_in >= MIN_LANDMARKS,
                X[inl].double().cpu().numpy(), len(X))


def pose_gap_px(T_a: np.ndarray, T_b: np.ndarray, pts: np.ndarray,
                cam: Camera) -> float:
    """Median over `pts` (previous-camera landmarks) of the distance between
    their projections into the current image under the motions T_a and T_b
    (each T_{prev<-cur})."""
    def proj(T):
        Ti = np.linalg.inv(T)
        P = pts @ Ti[:3, :3].T + Ti[:3, 3]
        return np.stack([cam.fx * P[:, 0] / P[:, 2], cam.fy * P[:, 1] / P[:, 2]], -1)
    return float(np.median(np.linalg.norm(proj(T_a) - proj(T_b), axis=1)))
