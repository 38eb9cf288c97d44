"""A plain pyramidal Lucas-Kanade tracker: the reference the program's LK
(the `lk_track_kernel` of rso_torch/csrc/lk_track.cu and its plain version)
is held to, in the tests and on the card.

Textbook forward-additive LK (Lucas and Kanade 1981; Bouguet's pyramidal
form, as OpenCV's calcOpticalFlowPyrLK runs it), one keypoint's window at
a time and all keypoints at once, in float64 by default, from nothing but
the images, by bilinear reads with the image's edge replicated:

  * the coarsest level starts from an exhaustive integer search: the least
    sum of absolute differences of an 8x8 window (rows y-3..y+4, columns
    x-3..x+4 about the rounded keypoint) over +-seed_range px, the first
    displacement in row-major order on ties;
  * at each level, coarse to fine, the template T and its central-difference
    gradients Ix, Iy are read at the keypoint's subpixel position over a
    (2 win + 1)^2 window; G = sum [Ix Iy]^T [Ix Iy] must have det > 1e-6, or
    the level keeps its initial flow; then `iters` Gauss-Newton steps
    d -= G^-1 sum [Ix Iy]^T (I(x + d) - T) of the window read in the
    current image, and the mean absolute residual at the end; the flow is
    doubled onto the next finer level;
  * a keypoint is tracked (status) where it was valid, every level's G
    passed, it lands at least 1 px inside the image, and the finest
    level's residual is at most max_err.

Departures from OpenCV's calcOpticalFlowPyrLK, each also the program's:

  * a fixed iteration count a level (`iters`, 10), with no epsilon stop
    (OpenCV stops after 30 iterations or a step under 0.01 px);
  * the coarse 8x8 SAD seed at the coarsest level, where OpenCV starts at
    zero flow;
  * the window's integer base may move at most SLACK px from where the level
    started (further, the window stays at that edge and only its bilinear
    fractions follow the flow), where OpenCV reads anywhere;
  * image borders replicate the edge pixel and a keypoint is clamped to
    [0, size - 1.001] before its window is read, where OpenCV reads with
    BORDER_REFLECT_101 and loses a point whose window leaves the image;
  * gradients are central differences of the bilinear template (OpenCV:
    Scharr derivatives of the level), and the gate is det(G) > 1e-6 (OpenCV:
    G's smallest eigenvalue over the window area against minEigThreshold);
  * the status also asks the mean absolute residual to be at most max_err
    (OpenCV reports the error beside the status and leaves the cut to its
    caller);
  * the pyramids are the caller's (OpenCV builds Gaussian pyrDown levels).

It imports nothing of the program and nothing of JAX.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SLACK = 5      # px the window's integer base may move from a level's start
SEED_WIN = 8   # the seed's SAD window, rows/cols -3..+4 of the keypoint


def _read(img: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """img[rows, cols] with the edge replicated (integer index tensors)."""
    h, w = img.shape
    return img[rows.clamp(0, h - 1), cols.clamp(0, w - 1)]


def _bilinear(img, rows, cols, fx, fy):
    """The bilinear read at integer bases (rows, cols) [K, n, n] plus the
    fractions fx, fy [K]."""
    fx, fy = fx[:, None, None], fy[:, None, None]
    return ((1 - fy) * (1 - fx) * _read(img, rows, cols)
            + (1 - fy) * fx * _read(img, rows, cols + 1)
            + fy * (1 - fx) * _read(img, rows + 1, cols)
            + fy * fx * _read(img, rows + 1, cols + 1))


def seed(prev, cur, pts, seed_range: int):
    """The integer flow [K, 2] (dx, dy) of the least 8x8 SAD over
    +-seed_range px about each keypoint, first in row-major order on ties.
    The windows are cut about the rounded keypoint and held, each as one
    piece, inside the image extended by seed_range + 4 px of replicated
    edge."""
    h, w = prev.shape
    pad = seed_range + 4
    S = SEED_WIN + 2 * seed_range
    D = 2 * seed_range + 1
    c = torch.round(pts.to(torch.float64) + pad).to(torch.int64)

    def origin(n, size, back):
        return (c[:, n] - back).clamp(0, (w, h)[n] + 2 * pad - size) - pad

    ar8 = torch.arange(SEED_WIN, device=prev.device)
    arS = torch.arange(S, device=prev.device)
    t = _read(prev, (origin(1, SEED_WIN, 3)[:, None] + ar8)[:, :, None],
              (origin(0, SEED_WIN, 3)[:, None] + ar8)[:, None, :])
    s = _read(cur, (origin(1, S, 3 + seed_range)[:, None] + arS)[:, :, None],
              (origin(0, S, 3 + seed_range)[:, None] + arS)[:, None, :])
    best = torch.full((pts.shape[0],), float("inf"), dtype=prev.dtype,
                      device=prev.device)
    arg = torch.zeros(pts.shape[0], dtype=torch.int64, device=prev.device)
    for dy in range(D):
        for dx in range(D):
            sad = (s[:, dy:dy + SEED_WIN, dx:dx + SEED_WIN] - t).abs().sum((1, 2))
            take = sad < best                      # strict: the first wins
            best = torch.where(take, sad, best)
            arg = torch.where(take, torch.full_like(arg, dy * D + dx), arg)
    return torch.stack([arg % D - seed_range, arg // D - seed_range],
                       1).to(prev.dtype)


def level(prev, cur, pts, guess, win: int, iters: int):
    """One level's LK from the initial flow `guess` [K, 2]: returns
    (flow [K, 2], mean absolute residual [K], det(G) > 1e-6 [K])."""
    h, w = prev.shape
    dt = prev.dtype
    r = win
    x = pts[:, 0].clamp(0, w - 1.001)
    y = pts[:, 1].clamp(0, h - 1.001)
    bx, by = torch.floor(x), torch.floor(y)
    fx, fy = x - bx, y - by
    off = torch.arange(-r, r + 1, device=prev.device)
    ibx, iby = bx.to(torch.int64), by.to(torch.int64)

    def template(oy, ox):
        return _bilinear(prev, (iby[:, None] + off + oy)[:, :, None],
                         (ibx[:, None] + off + ox)[:, None, :], fx, fy)

    T = template(0, 0)
    Ix = (template(0, 1) - template(0, -1)) * 0.5
    Iy = (template(1, 0) - template(-1, 0)) * 0.5
    Gxx = (Ix * Ix).sum((1, 2))
    Gxy = (Ix * Iy).sum((1, 2))
    Gyy = (Iy * Iy).sum((1, 2))
    det = Gxx * Gyy - Gxy * Gxy
    ok = det > 1e-6
    safe = torch.where(ok, det, torch.ones_like(det))
    cbx0 = torch.floor((x + guess[:, 0]).clamp(0, w - 1.001))
    cby0 = torch.floor((y + guess[:, 1]).clamp(0, h - 1.001))

    def window(g):
        qx = (x + g[:, 0]).clamp(0, w - 1.001)
        qy = (y + g[:, 1]).clamp(0, h - 1.001)
        cbx, cby = torch.floor(qx), torch.floor(qy)
        ix = (cbx0 + (cbx - cbx0).clamp(-SLACK, SLACK)).to(torch.int64)
        iy = (cby0 + (cby - cby0).clamp(-SLACK, SLACK)).to(torch.int64)
        return _bilinear(cur, (iy[:, None] + off)[:, :, None],
                         (ix[:, None] + off)[:, None, :], qx - cbx, qy - cby)

    g = guess.to(dt)
    for _ in range(iters):
        e = window(g) - T
        b1 = (Ix * e).sum((1, 2))
        b2 = (Iy * e).sum((1, 2))
        step = torch.stack([-(Gyy * b1 - Gxy * b2) / safe,
                            -(-Gxy * b1 + Gxx * b2) / safe], 1)
        g = g + torch.where(ok[:, None], step, torch.zeros_like(step))
    err = (window(g) - T).abs().mean((1, 2))
    return g, err, ok


def track(prev_pyr: list, cur_pyr: list, pts, valid, win: int = 10,
          iters: int = 10, max_err: float = 20.0, seed_range: int = 12,
          dtype=torch.float64):
    """Track pts [K, 2] (octave-0 coordinates of the pyramids, finest level
    first) from prev to cur; returns (pos [K, 2], status [K], err [K]), all
    computed in `dtype`."""
    prev_pyr = [p.to(dtype) for p in prev_pyr]
    cur_pyr = [c.to(dtype) for c in cur_pyr]
    pts = pts.to(dtype)
    L = len(prev_pyr)
    flow = torch.zeros_like(pts)
    ok_all = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    err = torch.zeros(pts.shape[0], dtype=dtype, device=pts.device)
    for lvl in range(L - 1, -1, -1):
        p = pts / 2 ** lvl
        if lvl == L - 1 and seed_range > 0:
            flow = seed(prev_pyr[lvl], cur_pyr[lvl], p, seed_range)
        flow, err, ok = level(prev_pyr[lvl], cur_pyr[lvl], p, flow, win, iters)
        ok_all &= ok
        if lvl > 0:
            flow = flow * 2
    pos = pts + flow
    h, w = cur_pyr[0].shape
    inb = ((pos[:, 0] >= 1) & (pos[:, 0] < w - 1) & (pos[:, 1] >= 1)
           & (pos[:, 1] < h - 1))
    return pos, valid & ok_all & inb & (err <= max_err), err
