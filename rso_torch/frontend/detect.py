"""Stage 2: feature detection — responses, NMS, top-K, patches, descriptors.

Counterpart of rso/frontend/detect.py (`detect_features`), every detector:

  dmFASTER  -> FAST-12 + Shi-Tomasi response (kernel 1, kernels/fast_detect.py)
  dmFAST_ORB-> the same response + oriented-BRIEF descriptors
  dmKLT     -> dense Shi-Tomasi response, no FAST gate
  dmORB     -> FAST-9 + Harris response; with orb_nlevels > 1 over the 1.2x
               scale ladder of `_detect_orb_multilevel`

then windowed-max or adaptive NMS, the border margin, exact top-K with the
subpixel parabola, 8x8 SAD patches gathered at the rounded keypoints, and,
where a descriptor method needs them, 256-bit rBRIEF descriptors packed into
eight int32 words (the reference's uint32 bits).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from rso_torch.config import DetectMethod, DetectParams, NMSMethod
from rso_torch.frontend.orb_pattern import LEARNED_PATTERN
from rso_torch.kernels.fast_detect import corner_response_auto
from rso_torch.kernels.stereo_fused import _f32

_BRIEF_N = 256
_PATCH = 37           # descriptor patch side (center at 18)
_PATCH_R = _PATCH // 2
_ORIENT_R = 15        # intensity-centroid radius

# FAST circle (radius-3 Bresenham, the canonical 16 offsets) as (dx, dy)
_FAST_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


class Features(NamedTuple):
    """Fixed-capacity feature set for one image at one octave."""

    xy: torch.Tensor        # [K,2] f32 pixel coords (octave scale)
    response: torch.Tensor  # [K] f32
    valid: torch.Tensor     # [K] bool
    desc: torch.Tensor      # [K,8] int32: the reference's uint32 BRIEF words
    patch: torch.Tensor     # [K,64] f32 flattened 8x8 SAD patch


def _shift2d(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[y,x] = img[y+dy, x+dx], WRAPPING at the edges — the reference's
    `_shift2d` is a roll, and its border behaviour is what the port keeps."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))


def fast_corner_mask(img: torch.Tensor, threshold, arc: int = 12) -> torch.Tensor:
    """Dense FAST-N segment test: [H,W] bool, False on the 3-px border ring.

    A pixel is a corner if >= `arc` contiguous circle pixels are all brighter
    than center+t or all darker than center-t.  `threshold` may be a device
    scalar (the threshold servo's state)."""
    t = (threshold.to(img.device, img.dtype)
         if isinstance(threshold, torch.Tensor) else
         torch.full((), threshold, dtype=img.dtype, device=img.device))
    hi = img + t
    lo = img - t
    bright = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    dark = torch.zeros_like(bright)
    for i, (dx, dy) in enumerate(_FAST_OFFSETS):
        n = _shift2d(img, dx, dy)
        bright = bright | ((n > hi).to(torch.int32) << i)
        dark = dark | ((n < lo).to(torch.int32) << i)

    def rotl16(b, s):
        s %= 16
        if s == 0:
            return b & 0xFFFF
        return ((b << s) | (b >> (16 - s))) & 0xFFFF

    def has_arc(b):
        # run-length doubling on the circular 16-bit word
        runs = {1: b}
        k = 1
        while 2 * k <= arc:
            runs[2 * k] = runs[k] & rotl16(runs[k], k)
            k *= 2
        need, acc, offset = arc, None, 0
        for p in sorted(runs, reverse=True):
            while need >= p:
                term = rotl16(runs[p], offset)
                acc = term if acc is None else (acc & term)
                offset += p
                need -= p
        return acc != 0

    corner = has_arc(bright) | has_arc(dark)
    H, W = img.shape
    border = torch.zeros_like(corner)
    border[3:H - 3, 3:W - 3].fill_(True)   # a fill, no host-to-device copy
    return corner & border


def _box_sum(img: torch.Tensor, r: int) -> torch.Tensor:
    """Sum over a (2r+1)^2 window, zero-padded, rows first then columns, in
    the reference's order."""
    H, W = img.shape
    s = 2 * r + 1
    p = F.pad(img, (0, 0, r, r))
    rows = sum(p[dy:dy + H, :] for dy in range(s))
    p = F.pad(rows, (r, r))
    return sum(p[:, dx:dx + W] for dx in range(s))


def shi_tomasi_response(img: torch.Tensor, win: int) -> torch.Tensor:
    """Dense min-eigenvalue of the (2*win+1)^2 box-averaged structure tensor
    of central-difference gradients."""
    gx = (_shift2d(img, 1, 0) - _shift2d(img, -1, 0)) * 0.5
    gy = (_shift2d(img, 0, 1) - _shift2d(img, 0, -1)) * 0.5
    # the window mean as a multiply by the float32 reciprocal: what the
    # reference's compiled `/ n` computes, and what PyTorch's CUDA division
    # by a scalar computes, so CPU, CUDA and kernel all round alike
    inv_n = float(np.float32(1.0 / (2 * win + 1) ** 2))
    gxx = _box_sum(gx * gx, win) * inv_n
    gyy = _box_sum(gy * gy, win) * inv_n
    gxy = _box_sum(gx * gy, win) * inv_n
    tr_half = 0.5 * (gxx + gyy)
    d = gxx - gyy
    det_term = _sqrt_rn(torch.clamp(0.25 * (d * d) + gxy * gxy, min=0.0))
    return tr_half - det_term


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device, as kernel
    1's __fsqrt_rn and PyTorch's CUDA sqrt compute it.  PyTorch's vectorised
    CPU sqrt is not correctly rounded: it is an ulp off in ~0.6% of values.
    The float64 root of a float32 value, rounded once to float32, is."""
    return torch.sqrt(x.double()).to(torch.float32)


def harris_response(img: torch.Tensor, win: int = 3,
                    k: float = 0.04) -> torch.Tensor:
    """Dense Harris score det - k tr^2 of the (2*win+1)^2 box-summed
    structure tensor (ORB's HARRIS_SCORE ordering)."""
    gx = (_shift2d(img, 1, 0) - _shift2d(img, -1, 0)) * 0.5
    gy = (_shift2d(img, 0, 1) - _shift2d(img, 0, -1)) * 0.5
    gxx = _box_sum(gx * gx, win)
    gyy = _box_sum(gy * gy, win)
    gxy = _box_sum(gx * gy, win)
    tr = gxx + gyy
    return (gxx * gyy - gxy * gxy) - (k * tr) * tr


def nms_grid(response: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep pixels that are the maximum of their (2r+1)^2 neighbourhood
    (-inf outside the image)."""
    r = max(int(radius), 1)
    wmax = F.max_pool2d(response[None, None], 2 * r + 1, stride=1,
                        padding=r)[0, 0]
    return response >= wmax


def adaptive_nms_select(xy: torch.Tensor, resp: torch.Tensor,
                        valid: torch.Tensor, num_out: int,
                        min_radius: float = 0.0,
                        crob: float = 0.9) -> torch.Tensor:
    """Adaptive (suppression-radius) NMS over a candidate list: a keypoint's
    radius is its squared distance to the nearest keypoint that beats it by
    the robustness factor (resp_i < crob * resp_j), infinite for the global
    maximum; keep the `num_out` largest radii above min_radius^2.  Returns
    the refined validity mask over the same slots."""
    K = xy.shape[0]
    d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
    stronger = (resp[:, None] < _f32(crob) * resp[None, :]) & valid[None, :]
    d2 = torch.where(stronger & valid[:, None], d2,
                     torch.full_like(d2, torch.inf))
    radius = d2.amin(dim=1)
    radius = torch.where(valid, radius, torch.full_like(radius, -torch.inf))
    order = torch.argsort(-radius, stable=True)          # descending radius
    rank = torch.scatter(torch.empty_like(order), 0, order,
                         torch.arange(K, device=xy.device))
    return valid & (rank < num_out) & (radius > min_radius * min_radius)


def select_topk(response: torch.Tensor, keep_mask: torch.Tensor, k: int,
                min_response: float = 0.0, subpixel: bool = True):
    """Top-K peaks of a masked response map -> (xy [K,2], resp [K], valid [K]).

    Exact top-K ordered by (value desc, flat index asc), the order of the
    reference's top-K: a stable descending sort.  With subpixel=True peaks
    are refined by a per-axis parabola on the response, clamped to +-0.5 px.
    """
    H, W = response.shape
    masked = torch.where(keep_mask, response,
                         torch.full_like(response, -torch.inf))
    vals, idx = torch.sort(masked.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    yi = idx // W
    xi = idx % W
    valid = torch.isfinite(vals) & (vals > min_response)
    xs = xi.to(torch.float32)
    ys = yi.to(torch.float32)
    if subpixel:
        def parab(vm, v0, vp):
            denom = vm - 2.0 * v0 + vp
            big = torch.abs(denom) > 1e-6
            off = torch.where(
                big, 0.5 * (vm - vp) / torch.where(big, denom,
                                                   torch.ones_like(denom)),
                torch.zeros_like(denom))
            return torch.clamp(off, -0.5, 0.5)

        xm = torch.clamp(xi - 1, 0, W - 1)
        xp = torch.clamp(xi + 1, 0, W - 1)
        ym = torch.clamp(yi - 1, 0, H - 1)
        yp = torch.clamp(yi + 1, 0, H - 1)

        def g(yy, xx):
            v = response[yy, xx]
            return torch.where(torch.isfinite(v), v, torch.zeros_like(v))

        v0 = g(yi, xi)
        zero = torch.zeros_like(v0)
        xs = xs + torch.where(valid, parab(g(yi, xm), v0, g(yi, xp)), zero)
        ys = ys + torch.where(valid, parab(g(ym, xi), v0, g(yp, xi)), zero)
    xy = torch.stack([xs, ys], dim=-1)
    return xy, torch.where(valid, vals, torch.zeros_like(vals)), valid


def extract_patches_wide(img: torch.Tensor, xy: torch.Tensor, size: int,
                         offset: int) -> torch.Tensor:
    """size x size windows at the rounded keypoints -> [K, size, size]; the
    window (x-offset.., y-offset..) is clamped into the image as one unit.
    A gather: the reference's one-hot lane pulls exist only to avoid TPU
    gathers, and select the same pixels."""
    H, W = img.shape
    x0 = torch.clamp(torch.round(xy[:, 0]).to(torch.int64) - offset, 0, W - size)
    y0 = torch.clamp(torch.round(xy[:, 1]).to(torch.int64) - offset, 0, H - size)
    r = torch.arange(size, device=img.device)
    rows = (y0[:, None] + r[None, :])[:, :, None]
    cols = (x0[:, None] + r[None, :])[:, None, :]
    return img[rows, cols]


def extract_patches(img: torch.Tensor, xy: torch.Tensor, size: int = 8,
                    offset: int = 3) -> torch.Tensor:
    """size x size SAD patches at the rounded keypoints -> [K, size*size]
    (the window x-3..x+4, y-3..y+4 of the reference's compute_SAD8)."""
    return extract_patches_wide(img, xy, size, offset).reshape(
        xy.shape[0], size * size)


def orb_orientation(patch31: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle of [K,31,31] patches (ORB's orientation).

    The two moments are summed in float64, where they are exact (f32 pixel
    values times integer weights of at most 15, ~700 terms), and rounded
    once to f32, so every device gets the same moments whatever its
    summation order; atan2 then runs in f32 as in the reference."""
    r = torch.arange(-_ORIENT_R, _ORIENT_R + 1, dtype=torch.float64,
                     device=patch31.device)
    circle = (r[None, :] ** 2 + r[:, None] ** 2) <= _ORIENT_R ** 2
    wx = r[None, :] * circle
    wy = r[:, None] * circle
    p = patch31.to(torch.float64)
    m10 = (p * wx).sum(dim=(-2, -1)).to(torch.float32)
    m01 = (p * wy).sum(dim=(-2, -1)).to(torch.float32)
    return torch.atan2(m01, m10)


@functools.lru_cache(maxsize=None)
def _brief_pattern(device: torch.device) -> torch.Tensor:
    """The [256, 2(pair), 2(xy)] f32 test pattern, copied to `device` once."""
    return torch.from_numpy(np.asarray(LEARNED_PATTERN, np.float32)).to(device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[K, 32*n] bool -> [K, n] int32 words, bit b of word w = bits[32w + b].
    The words are built in int64 and wrapped explicitly into int32, so bit
    31 gives a negative word with the reference's uint32 bits."""
    K = bits.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(K, -1, 32).to(torch.int64) << shifts).sum(-1)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def orb_descriptors(img: torch.Tensor, xy: torch.Tensor,
                    upright: bool = False) -> torch.Tensor:
    """Oriented-BRIEF 256-bit descriptors, packed int32 [K,8].

    Per keypoint: the 37x37 patch, the intensity-centroid orientation of its
    central 31x31, the learned pair pattern rotated by it, and bilinear
    samples of the 5x5-box-smoothed patch compared pairwise.  The bilinear
    sample is a 4-tap gather in a fixed order,
    (1-fy)*((1-fx)*a + fx*b) + fy*((1-fx)*c + fx*d): upright patterns sit on
    integer offsets (fx = fy = 0), so every upright sample is exact."""
    patches = extract_patches_wide(img, xy, _PATCH, _PATCH_R)   # [K,37,37]
    K = patches.shape[0]
    if upright:
        c = torch.ones((K, 1), dtype=torch.float32, device=img.device)
        s = torch.zeros_like(c)
    else:
        theta = orb_orientation(patches[:, 3:34, 3:34])[:, None]
        c, s = torch.cos(theta), torch.sin(theta)
    # 5x5 box smoothing: zero-padded shift-adds, rows then columns (pattern
    # points stay >= 4 px inside the patch, so the padding never reaches a
    # sample)
    pp = F.pad(patches, (0, 0, 2, 2))
    rows = sum(pp[:, dy:dy + _PATCH, :] for dy in range(5))
    pp = F.pad(rows, (2, 2))
    sm = sum(pp[:, :, dx:dx + _PATCH] for dx in range(5)).reshape(K, -1)

    pattern = _brief_pattern(img.device)
    pxs = pattern[..., 0].reshape(1, -1)                          # [1,512]
    pys = pattern[..., 1].reshape(1, -1)
    cc = (_PATCH - 1) / 2.0
    xf = torch.clamp(pxs * c - pys * s + cc, 0.0, _f32(_PATCH - 1.001))
    yf = torch.clamp(pxs * s + pys * c + cc, 0.0, _f32(_PATCH - 1.001))
    xb = xf.to(torch.int64)
    yb = yf.to(torch.int64)
    fx = xf - xb.to(torch.float32)
    fy = yf - yb.to(torch.float32)
    base = yb * _PATCH + xb

    def tap(dy, dx):
        return torch.gather(sm, 1, base + (dy * _PATCH + dx))

    v = ((1 - fy) * ((1 - fx) * tap(0, 0) + fx * tap(0, 1))
         + fy * ((1 - fx) * tap(1, 0) + fx * tap(1, 1)))
    v = v.reshape(K, _BRIEF_N, 2)
    return pack_bits(v[..., 0] < v[..., 1])


def octave_budget(orb_nfeats: int, n_octaves: int) -> list[int]:
    """Per-octave target feature counts (reference stage2_detect.cpp:405-407):
    k0 = nfeats * 2*O / (2^O - 1), k_o = k0 / 2^o."""
    if n_octaves == 1:
        return [orb_nfeats]
    k0 = int(orb_nfeats * (2 * n_octaves) / (2 ** n_octaves - 1))
    return [max(1, int(round(k0 / 2 ** o))) for o in range(n_octaves)]


def octave_k_slots(orb_nfeats: int, n_octaves: int, k_max: int,
                   decay: bool = True) -> list[int]:
    """Per-octave slot capacities: the smallest multiple of 128 covering the
    octave budget, capped at k_max (uniform k_max without decay)."""
    if not decay:
        return [k_max] * n_octaves
    return [min(k_max, max(128, -(-b // 128) * 128))
            for b in octave_budget(orb_nfeats, n_octaves)]


def _inside(shape, margin: int, device) -> torch.Tensor:
    """[H,W] bool: True at least `margin` px away from every edge."""
    H, W = shape
    inb = torch.zeros((H, W), dtype=torch.bool, device=device)
    inb[margin:H - margin, margin:W - margin].fill_(True)
    return inb


def _descriptors(img, xy, valid, need_desc: bool, upright: bool):
    if not need_desc:
        return torch.zeros((xy.shape[0], 8), dtype=torch.int32,
                           device=img.device)
    desc = orb_descriptors(img, xy, upright=upright)
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


def _orb_level_budgets(k_slots: int, nlevels: int) -> list[int]:
    """Per-level feature budgets, geometric with factor 1/1.2 like cv::ORB's
    per-level split, summing exactly to k_slots with every level >= 1 (the
    ladder is cut short when k_slots < nlevels)."""
    nlevels = max(1, min(nlevels, k_slots))
    raw = [(1.0 / 1.2) ** lv for lv in range(nlevels)]
    scale = k_slots / sum(raw)
    ks = [max(1, int(round(r * scale))) for r in raw]
    diff, j = k_slots - sum(ks), 0
    while diff != 0:        # walk the levels, one slot at a time
        i = j % nlevels
        if diff > 0:
            ks[i] += 1
            diff -= 1
        elif ks[i] > 1:
            ks[i] -= 1
            diff += 1
        j += 1
    return ks


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] f32 weights of an antialiased bilinear downsample: the
    triangle filter of jax.image.resize (jax/_src/image/scale.py
    `compute_weight_mat`, translation 0), in float32 with the roundings its
    compiled CPU form takes where they are known (an FMA for the sample
    position, a reciprocal for the kernel scale).  The normalising sum is
    taken in ascending order; the reference's order is its compiler's, so
    weights may differ from it by a few ulps."""
    f = np.float32
    inv_scale = f(1.0 / (out_size / in_size))    # a Python float, then f32
    kernel_scale = max(inv_scale, f(1.0))
    # one rounding of (j + 0.5) * inv_scale - 0.5: XLA contracts it into an
    # FMA, and the product of two f32 values is exact in f64
    sample_f = ((np.arange(out_size, dtype=f) + f(0.5)).astype(np.float64)
                * np.float64(inv_scale) - 0.5).astype(f)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f)[:, None]) \
        * (f(1.0) / kernel_scale)
    w = np.maximum(f(0.0), f(1.0) - np.abs(x))
    total = np.zeros((1, out_size), f)
    for i in range(in_size):            # ascending input index
        total = total + w[i:i + 1]
    w = np.where(np.abs(total) > f(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f(0.0)).astype(f)


@functools.lru_cache(maxsize=None)
def _resize_taps(in_size: int, out_size: int, device: torch.device):
    """The resize's band of nonzero weights as (index [out,T] int64, weight
    [out,T] f32), on `device`; taps past the band carry weight 0."""
    w = _resize_weights(in_size, out_size)
    nz = w != 0
    lo = np.where(nz.any(0), nz.argmax(0), 0)
    hi = np.where(nz.any(0), in_size - 1 - nz[::-1].argmax(0), 0)
    T = int((hi - lo).max()) + 1
    idx = np.minimum(lo[:, None] + np.arange(T)[None, :], in_size - 1)
    wt = np.take_along_axis(w.T, idx, axis=1)
    wt = np.where(lo[:, None] + np.arange(T)[None, :] <= hi[:, None], wt, 0)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(wt.astype(np.float32)).to(device))


def resize_bilinear(img: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """jax.image.resize(img, out_hw, "bilinear") for a downsample: the
    antialiased triangle filter, rows first and then columns, each output a
    sum over its band of taps in ascending input order (a fixed order, so
    CPU and GPU agree bit for bit)."""
    def along_rows(x, out_size):        # [H,W] -> [out,W]
        idx, wt = _resize_taps(x.shape[0], out_size, x.device)
        acc = wt[:, 0:1] * x[idx[:, 0]]
        for t in range(1, idx.shape[1]):
            acc = acc + wt[:, t:t + 1] * x[idx[:, t]]
        return acc

    Hl, Wl = out_hw
    return along_rows(along_rows(img, Hl).T, Wl).T.contiguous()


def _detect_orb_multilevel(img: torch.Tensor, params: DetectParams,
                           k_slots: int, fast_threshold,
                           need_desc: bool) -> Features:
    """ORB over the internal 1.2x scale ladder (reference ORB mode: one
    engine octave, orb_nlevels internal scales).  Per level: antialiased
    bilinear resize, FAST-9 + Harris, grid NMS, top-K within the level's
    budget, descriptors on the level image, coordinates mapped back to full
    resolution with the half-pixel convention.  SAD patches come from the
    full-resolution image."""
    H, W = img.shape
    budgets = _orb_level_budgets(k_slots, params.orb_nlevels)
    xs, rs, vs, ds = [], [], [], []
    for lv, k in enumerate(budgets):
        s = 1.2 ** lv
        Hl, Wl = max(int(round(H / s)), 64), max(int(round(W / s)), 64)
        lvl = img if lv == 0 else resize_bilinear(img, (Hl, Wl))
        corner = fast_corner_mask(lvl, fast_threshold, arc=9)
        resp = torch.where(corner, harris_response(lvl),
                           torch.full_like(lvl, -torch.inf))
        keep = nms_grid(resp, params.min_distance) & corner
        keep = keep & _inside((Hl, Wl), _PATCH_R + 1 if need_desc else 5,
                              img.device)
        xy, resp_k, valid = select_topk(resp, keep, k,
                                        params.minimum_ORB_response)
        xy = torch.where(valid[:, None], xy, torch.zeros_like(xy))
        ds.append(_descriptors(lvl, xy, valid, need_desc, params.orb_upright))
        # (x + 0.5) * (W / Wl) - 0.5, clamped inside the base margin
        xyf = torch.stack([
            torch.clamp((xy[:, 0] + 0.5) * _f32(W / Wl) - 0.5, 5.0, W - 6.0),
            torch.clamp((xy[:, 1] + 0.5) * _f32(H / Hl) - 0.5, 5.0, H - 6.0),
        ], dim=-1)
        xs.append(torch.where(valid[:, None], xyf, torch.zeros_like(xyf)))
        rs.append(resp_k)
        vs.append(valid)
    xy = torch.cat(xs)
    valid = torch.cat(vs)
    patch = extract_patches(img, xy)
    return Features(xy=xy, response=torch.cat(rs), valid=valid,
                    desc=torch.cat(ds),
                    patch=torch.where(valid[:, None], patch,
                                      torch.zeros_like(patch)))


def detect_features(img: torch.Tensor, params: DetectParams, k_slots: int,
                    fast_threshold, need_desc: bool, arc: int = 12) -> Features:
    """Detect up to k_slots features on one octave image.  `fast_threshold`
    may be a device scalar (the threshold servo's state)."""
    method = params.detect_method
    if method == DetectMethod.ORB and params.orb_nlevels > 1:
        return _detect_orb_multilevel(img, params, k_slots, fast_threshold,
                                      need_desc)
    if method == DetectMethod.KLT:
        resp = shi_tomasi_response(img, params.KLT_win)
        keep = nms_grid(resp, params.min_distance)
        min_resp = params.minimum_KLT_response
    elif method == DetectMethod.ORB:
        corner = fast_corner_mask(img, fast_threshold,
                                  arc=9 if arc == 12 else arc)
        resp = torch.where(corner, harris_response(img),
                           torch.full_like(img, -torch.inf))
        keep = nms_grid(resp, params.min_distance) & corner
        min_resp = params.minimum_ORB_response
    else:   # FASTER / FAST_ORB: FAST corners ranked by the Shi-Tomasi response
        resp = corner_response_auto(img, fast_threshold, arc=arc,
                                    win=params.KLT_win)
        keep = nms_grid(resp, params.min_distance) & (resp > -torch.inf)
        min_resp = (params.minimum_KLT_response
                    if method == DetectMethod.FASTER else 0.0)

    use_adaptive = (params.non_maximal_suppression
                    and params.nmsMethod == NMSMethod.ADAPTIVE)
    if use_adaptive:
        # a 3x3 local-max prefilter, then radius suppression after top-K
        keep = nms_grid(resp, 1)
    if not params.non_maximal_suppression:
        keep = (torch.ones_like(keep) if method == DetectMethod.KLT
                else resp > -torch.inf)

    # border margin: SAD patches need 4 px, descriptors the 37x37 patch
    margin = _PATCH_R + 1 if need_desc else max(4, params.KLT_win + 1)
    xy, resp_k, valid = select_topk(
        resp, keep & _inside(img.shape, margin, img.device), k_slots, min_resp)
    if use_adaptive:
        valid = adaptive_nms_select(xy, resp_k, valid, k_slots)
    xy = torch.where(valid[:, None], xy, torch.zeros_like(xy))
    patch = extract_patches(img, xy)
    return Features(
        xy=xy, response=resp_k, valid=valid,
        desc=_descriptors(img, xy, valid, need_desc, params.orb_upright),
        patch=torch.where(valid[:, None], patch, torch.zeros_like(patch)))


def update_fast_threshold(threshold: torch.Tensor, n_feats: torch.Tensor,
                          img_area: int, params: DetectParams) -> torch.Tensor:
    """The FAST threshold servo (reference stage2_detect.cpp:537-550): +-1
    steps toward target_feats_per_pixel, clamped to [1, inf)."""
    density = n_feats.to(torch.float32) / float(img_area)
    lo = density < 0.8 * params.target_feats_per_pixel
    hi = density > 1.2 * params.target_feats_per_pixel
    return torch.where(lo, torch.clamp(threshold - 1, min=1),
                       torch.where(hi, threshold + 1, threshold))
