"""Inputs for the stereo-SAD kernel (kernel 2) and its twin: the cases a
kernel that evaluates the geometric mask before any SAD must reproduce.

numpy only, so that the CUDA tests (no jax) and the CPU parity tests share
them.  Patch values are multiples of 1/16 in [0, 255], as pyramid pixels
are, so every SAD is exact in float32.
"""
from __future__ import annotations

import numpy as np

W, H = 1241, 376
# the engine's mask at octave 0 (synthetic_config: max_y_diff 1, max_disp
# 0.7 W, sad_max_distance 4000)
SPARSE_KW = dict(max_y_diff=1.0, max_disp=0.7 * W, max_distance=4000.0)
# every valid pair with a disparity >= 1: the mask-first kernel's worst case
OPEN_KW = dict(max_y_diff=1e4, max_disp=1e4, max_distance=4000.0)

CASES = ("sparse", "no_admissible_rows", "ok_l_false", "y_half_even",
         "disp_edges", "over_max_distance", "one_admitted", "equal_sads",
         "kl200_kr131", "kl131_kr257", "k1", "kl1_kr64", "kl64_kr1", "open")


def _patches(r, k):
    return r.integers(0, 255 * 16, (k, 64)) / 16.0


def stereo_case(name: str):
    """Returns (args, kw, rows, cols, wins): the six operands of
    stereo_sad_fused as float32/bool numpy arrays, its mask keywords, the
    left rows the case is about, the right slot planted as each one's match
    (in "equal_sads": the lower of its two equal copies), and whether that
    slot must win (True) or must not (False)."""
    kl, kr = {"kl200_kr131": (200, 131), "kl131_kr257": (131, 257),
              "k1": (1, 1), "kl1_kr64": (1, 64), "kl64_kr1": (64, 1)}.get(
                  name, (256, 256))
    r = np.random.default_rng(100 + CASES.index(name))
    p_l, p_r = _patches(r, kl), _patches(r, kr)
    # features spread over a 1241x376 image
    xy_l = np.stack([r.uniform(0, W, kl), r.uniform(0, H, kl)], -1)
    xy_r = np.stack([r.uniform(0, W, kr), r.uniform(0, H, kr)], -1)
    ok_l, ok_r = r.random(kl) > 0.1, r.random(kr) > 0.1
    # right slot dst[i] sees left slot src[i]: a noisy patch 2-60 px to the
    # left, within 0.4 px in y
    n = max(1, 3 * min(kl, kr) // 4)
    src, dst = r.permutation(kl)[:n], r.permutation(kr)[:n]
    p_r[dst] = np.clip(p_l[src] + r.integers(-30, 30, (n, 64)) / 16.0, 0, 255)
    xy_r[dst, 0] = xy_l[src, 0] - r.uniform(2, 60, n)
    xy_r[dst, 1] = xy_l[src, 1] + r.uniform(-0.4, 0.4, n)
    ok_l[src] = ok_r[dst] = True
    # the last pairs also get a second candidate inside the mask at a free
    # slot, every value 40-80/16 off toward mid-grey: a SAD of 160-320,
    # above the planted pair's (at most 120), so second < 1e9 there
    c = min(n // 4, kr - n)
    near = r.permutation(np.setdiff1d(np.arange(kr), dst))[:c]
    base = p_l[src[n - c:]]
    p_r[near] = base + np.where(base < 127.5, 1.0, -1.0) * r.integers(
        40, 81, (c, 64)) / 16.0
    xy_r[near] = xy_r[dst[n - c:]] + np.stack(
        [r.uniform(-1, 1, c), r.uniform(-0.4, 0.4, c)], -1)
    ok_r[near] = True
    cols, wins = dst.copy(), np.ones(n, bool)
    kw = dict(OPEN_KW if name == "open" else SPARSE_KW)
    m = min(n, 60)   # the rows a special case changes
    q = m // 4
    if name == "no_admissible_rows":
        xy_l[src[:m], 1] += 5000.0   # far from every right row
        wins[:m] = False
    elif name == "ok_l_false":
        ok_l[src[:m]] = False
        wins[:m] = False
    elif name == "y_half_even":
        # one y of each pair on a .5 boundary, y even: round half to
        # even admits groups 0 and 2 (|dy| = 1) and rejects groups 1 and 3
        # (|dy| = 2); rounding half away from zero would do the opposite
        y = 20.0 + 4.0 * np.arange(m)
        g = np.arange(m) % 4
        xy_l[src[:m], 1] = y + np.array([0.5, 0.5, -0.8, 0.2])[g]
        xy_r[dst[:m], 1] = y + np.array([-0.6, 2.2, 0.5, -1.5])[g]
        wins[:m] = g % 2 == 0
    elif name == "disp_edges":
        # disparity exactly 1 and exactly max_disp (admitted), 1 - 1/16 and
        # max_disp plus one ulp (rejected)
        md = np.float32(kw["max_disp"])
        ulp = np.spacing(md)
        xr = r.uniform(4, 300, m).astype(np.float32).round()
        d = np.concatenate([np.full(q, 1.0, np.float32), np.full(q, md),
                            np.full(q, 0.9375, np.float32),
                            np.full(m - 3 * q, md + ulp, np.float32)])
        xy_r[dst[:m], 0] = xr
        xy_l[src[:m], 0] = xr + d   # exact in float32
        wins[2 * q:m] = False
    elif name == "over_max_distance":
        # the planted pair stays inside the mask, its patch no longer
        # matches: every value 80 off, a SAD of 5120 > 4000
        pl = p_l[src[:m]]
        p_r[dst[:m]] = pl + np.where(pl < 127.5, 80.0, -80.0)
        wins[:m] = False
    elif name == "one_admitted":
        # these rows 4 px apart in a band no other right slot reaches:
        # exactly one admissible pair each, so second = 1e9
        m = min(m, 16)
        others = np.setdiff1d(np.arange(kr), dst[:m])
        xy_r[others, 1] = np.minimum(xy_r[others, 1], 300.0)
        xy_l[src[:m], 1] = 310.0 + 4.0 * np.arange(m)
        xy_r[dst[:m], 1] = xy_l[src[:m], 1]
    elif name == "equal_sads":
        # a copy of each planted right slot at another slot: equal SADs, the
        # lower index must win and second == best
        copy = r.permutation(np.setdiff1d(np.arange(kr), dst))[:m]
        p_r[copy], xy_r[copy], ok_r[copy] = p_r[dst[:m]], xy_r[dst[:m]], True
        cols[:m] = np.minimum(dst[:m], copy)
    if name in ("no_admissible_rows", "ok_l_false", "y_half_even",
                "disp_edges", "over_max_distance", "one_admitted",
                "equal_sads"):
        src, cols, wins = src[:m], cols[:m], wins[:m]
    order = np.argsort(src)
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    args = (f(p_l), f(p_r), f(xy_l), f(xy_r), ok_l.copy(), ok_r.copy())
    return args, kw, src[order], cols[order], wins[order]
