"""Inputs for the tracking-SAD kernel (kernel 3) and its twin: the cases a
kernel that evaluates the window mask before any SAD must reproduce.

numpy only, so that the CUDA tests (no jax) and the CPU parity tests share
them.  Patch values are multiples of 1/16 in [0, 255], as pyramid pixels
are, so every SAD is exact in float32.
"""
from __future__ import annotations

import numpy as np

# the engine's window (synthetic_config: ifm_win 40, sad_max_distance 4000)
SPARSE_KW = dict(win_row=40.0, win_col=40.0, sad_max=4000.0)
# every pair inside the window: the mask-first kernel's worst case
DENSE_KW = dict(win_row=1e4, win_col=1e4, sad_max=4000.0)

CASES = ("sparse", "no_admissible_rows", "ok_p_false", "one_eye_over_sad_max",
         "equal_sads", "kp200_kc131", "kp131_kc257", "k1", "kp1_kc64",
         "kp64_kc1", "dense")


def _patches(r, k):
    return r.integers(0, 255 * 16, (k, 64)) / 16.0


def _noisy(r, p):
    return np.clip(p + r.integers(-30, 30, p.shape) / 16.0, 0.0, 255.0)


def track_case(name: str):
    """Returns (args, kw, rows, cols): the ten operands of track_sad_fused
    as float32/bool numpy arrays, its window keywords, and the prev rows the
    case is about with, for each, the cur slot planted as its match (in
    "equal_sads": the lower of its two equal copies)."""
    kp, kc = {"kp200_kc131": (200, 131), "kp131_kc257": (131, 257),
              "k1": (1, 1), "kp1_kc64": (1, 64), "kp64_kc1": (64, 1)}.get(
                  name, (256, 256))
    r = np.random.default_rng(CASES.index(name))
    p_left, p_right = _patches(r, kp), _patches(r, kp)
    c_left, c_right = _patches(r, kc), _patches(r, kc)
    # features spread over a 1241x376 image, right eye 2-60 px to the left
    p_xy = np.stack([r.uniform(0, 1241, kp), r.uniform(0, 376, kp)], -1)
    c_xy = np.stack([r.uniform(0, 1241, kc), r.uniform(0, 376, kc)], -1)
    p_rx = p_xy[:, 0] - r.uniform(2, 60, kp)
    c_rx = c_xy[:, 0] - r.uniform(2, 60, kc)
    ok_p, ok_c = r.random(kp) > 0.1, r.random(kc) > 0.1
    # cur slot dst[i] sees prev slot src[i]: noisy patches, moved <= 6 px
    n = max(1, 3 * min(kp, kc) // 4)
    src, dst = r.permutation(kp)[:n], r.permutation(kc)[:n]
    c_left[dst], c_right[dst] = _noisy(r, p_left[src]), _noisy(r, p_right[src])
    c_xy[dst] = p_xy[src] + r.uniform(-6, 6, (n, 2))
    c_rx[dst] = p_rx[src] + r.uniform(-6, 6, n)
    ok_c[dst] = True
    ok_p[src] = True
    m = min(n, 60)   # the rows a special case changes
    if name == "no_admissible_rows":
        # far outside every candidate's window
        p_xy[src[:m], 0] += 5000.0
        p_rx[src[:m]] += 5000.0
    elif name == "ok_p_false":
        ok_p[src[:m]] = False
    elif name == "one_eye_over_sad_max":
        # the planted pair stays in the window, its right patch no longer
        # matches: every value 80 off, a right-eye SAD of 5120 > 4000
        pr = p_right[src[:m]]
        c_right[dst[:m]] = pr + np.where(pr < 127.5, 80.0, -80.0)
    elif name == "equal_sads":
        # a copy of each planted candidate at another slot: equal SADs, the
        # lower index must win
        copy = r.permutation(np.setdiff1d(np.arange(kc), dst))[:m]
        for a in (c_left, c_right, c_xy, c_rx, ok_c):
            a[copy] = a[dst[:m]]
        dst = dst.copy()
        dst[:m] = np.minimum(dst[:m], copy)
    if name in ("no_admissible_rows", "ok_p_false", "one_eye_over_sad_max",
                "equal_sads"):
        src, dst = src[:m], dst[:m]
    order = np.argsort(src)
    kw = DENSE_KW if name == "dense" else SPARSE_KW
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    args = (f(p_left), f(c_left), f(p_right), f(c_right), f(p_xy), f(c_xy),
            f(p_rx), f(c_rx), ok_p.copy(), ok_c.copy())
    return args, dict(kw), src[order], dst[order]

