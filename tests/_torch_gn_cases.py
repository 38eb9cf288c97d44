"""Pose-solve problems for the GN iteration kernel's checks
(tests/test_torch_gn_iter.py, chip_smoke.py), made with the port alone, no
jax: tests/test_solver.py's cases as tests/test_torch_solver.py makes them,
the degenerate ones, a frame's [T] slots at the engine's shapes, and the
comparison of the kernel's carry with the plain iteration's (`same_carry`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rso_torch.config import LeastSquaresParams
from rso_torch.geometry import StereoCamera
from rso_torch.geometry.se3 import pose_inverse
from rso_torch.geometry.stereo_camera import project_stereo, triangulate
from rso_torch.solver import robust_gn as G

CAM_ARGS = dict(fx_l=718.856, fy_l=718.856, cx_l=607.19, cy_l=185.21,
                baseline=0.5371)
DEFAULT_POSE = np.asarray([0.01, -0.02, 0.005, 0.05, -0.02, 0.3], np.float32)

CASES = {
    "exact": dict(),
    "noisy": dict(noise=0.5),
    "outliers": dict(noise=0.3, n_outliers=30),
    "masked_padding": dict(n=150, pad_to=256, noise=0.2),
    "too_few": dict(n=6),
    "identity": dict(pose=np.zeros(6, np.float32)),
    "larger_rotation": dict(pose=np.asarray([0.05, 0.1, -0.03, 0.2, 0.1, 1.0],
                                            np.float32), noise=0.2),
}

# every variant the kernel has, per-slot weights apart
VARIANTS = {
    "robust": dict(),
    "no_robust_kernel": dict(use_robust_kernel=False),
    "no_irls": dict(irls_hessian_weighting=False),
    "lm": dict(use_lm=True),
    "eigh": dict(solve_backend="eigh"),
    "eigh_lm": dict(solve_backend="eigh", use_lm=True),
}

# a frame's slots: octaves of 512, 256 and 128 (kitti, T = 896)
FRAME_SLOTS = (512, 256, 128)


# The kernel's carry against the plain iteration's: integer fields and LM's
# lambda exact, the increment within POSE_ATOL plus STEP_RTOL of the step,
# residuals and cost within RES_* and COST_RTOL (the GN kernel's card check:
# tests/test_torch_gn_iter.py and chip_smoke.py, through
# tests/_torch_card.check_kernel)
INTS = ("it", "active", "times_inc", "abort", "ec")
POSE_ATOL = 1e-5
RES_ATOL = 5e-3
RES_RTOL = 1e-5
COST_RTOL = 5e-3
STEP_RTOL = 1e-4


def same_carry(got, want, what, start):
    """Hold the kernel's carry `got` to the plain iteration's `want`, both
    one iteration from `start` (the tolerances above)."""
    for name in INTS:
        assert torch.equal(getattr(got, name), getattr(want, name)), (
            f"{what}: {name} {getattr(got, name)} != {getattr(want, name)}")
    step = (want.dp - start.dp).abs().max().item()
    torch.testing.assert_close(got.dp, want.dp, rtol=0,
                               atol=POSE_ATOL + STEP_RTOL * step,
                               msg=msg(what, "dp"))
    close_res(got.res, want.res, what)
    close_cost(got.cost, want.cost, what)
    if want.lam is not None:
        assert torch.equal(got.lam, want.lam), f"{what}: lam"


def msg(what, field):
    return lambda m: f"{what}: {field}: {m}"


def close_res(got, want, what):
    torch.testing.assert_close(got, want, rtol=RES_RTOL, atol=RES_ATOL,
                               equal_nan=True, msg=msg(what, "residuals"))


def close_cost(got, want, what):
    torch.testing.assert_close(got, want, rtol=COST_RTOL, atol=RES_ATOL,
                               equal_nan=True, msg=msg(what, "cost"))


def camera(device="cpu") -> StereoCamera:
    return StereoCamera.make(**CAM_ARGS, device=device)


def params(variant: str, **kw) -> LeastSquaresParams:
    return dataclasses.replace(LeastSquaresParams(**VARIANTS[variant]), **kw)


def make_problem(seed, n=200, pose=DEFAULT_POSE, noise=0.0, n_outliers=0,
                 pad_to=None):
    """prev/cur stereo observations [n, 4] of a random cloud under a known
    camera motion, and the mask (numpy)."""
    cam = camera()
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(-5, 5, n),
                    rng.uniform(5.0, 40.0, n)], -1).astype(np.float32)
    P = torch.from_numpy(pts)
    prev = project_stereo(cam, P, torch.zeros(6)).numpy()
    cur = project_stereo(cam, P, pose_inverse(torch.from_numpy(
        np.asarray(pose, np.float32)))).numpy()
    if noise > 0:
        prev = prev + rng.normal(0, noise, prev.shape).astype(np.float32)
        cur = cur + rng.normal(0, noise, cur.shape).astype(np.float32)
    mask = np.ones(n, bool)
    if n_outliers:
        idx = rng.choice(n, n_outliers, replace=False)
        cur[idx] += rng.uniform(20, 60, (n_outliers, 4)).astype(np.float32)
    if pad_to and pad_to > n:
        pad = pad_to - n
        prev = np.concatenate([prev, np.zeros((pad, 4), np.float32)])
        cur = np.concatenate([cur, np.zeros((pad, 4), np.float32)])
        mask = np.concatenate([mask, np.zeros(pad, bool)])
    return prev.astype(np.float32), cur.astype(np.float32), mask


def slot_weights(n: int) -> np.ndarray:
    return np.where(np.arange(n) % 3 == 0, 0.25, 1.0).astype(np.float32)


def case_inputs(case: str, device="cpu", weighted=False):
    """(prev, cur, mask, weight or None) of a CASES problem as tensors."""
    prev, cur, mask = make_problem(sorted(CASES).index(case), **CASES[case])
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(prev), t(cur), t(mask), (t(slot_weights(len(mask))) if weighted
                                      else None)


def frame_inputs(seed: int, device="cpu", slots=FRAME_SLOTS):
    """A frame's stage-5 inputs at the engine's shapes: T = sum(slots)
    correspondences, octave o's pixels and weights scaled by 2^-o as the
    engine scales them, ~65% of the slots valid, 10% of those outliers."""
    rng = np.random.default_rng(seed)
    prevs, curs, masks, ws = [], [], [], []
    for o, k in enumerate(slots):
        prev, cur, mask = make_problem(
            int(rng.integers(1 << 30)), n=k, noise=0.3,
            n_outliers=k // 10)
        mask &= rng.random(k) < 0.65
        prevs.append(prev)
        curs.append(cur)
        masks.append(mask)
        ws.append(np.full(k, 4.0 ** o, np.float32))
    t = lambda a: torch.from_numpy(np.concatenate(a)).to(device)  # noqa: E731
    return t(prevs), t(curs), t(masks), t(ws)


def landmarks(prev: torch.Tensor) -> torch.Tensor:
    cam = camera(prev.device)
    return triangulate(cam, prev[:, 0], prev[:, 1], prev[:, 2])


def carry(T: int, dp, params: LeastSquaresParams, it=0, cost=0.0,
          times_inc=0, active=True, device="cpu") -> G.GNCarry:
    """A GN carry at iteration `it` from increment `dp`."""
    def f(x, dtype):
        return torch.tensor(x, dtype=dtype, device=device)
    return G.GNCarry(
        it=f(it, torch.int32), active=f(active, torch.bool),
        dp=f(np.asarray(dp, np.float32), torch.float32),
        cost=f(cost, torch.float32), times_inc=f(times_inc, torch.int32),
        abort=f(False, torch.bool),
        res=torch.full((T,), G._F32_MAX, device=device),
        ec=f(G.VOEC_NONE, torch.int32),
        lam=(f(params.lm_init_lambda, torch.float32) if params.use_lm
             else None))


def clone(c: G.GNCarry) -> G.GNCarry:
    return G.GNCarry(*(None if x is None else x.clone() for x in c))


# degenerate iterations: name -> (variants it is defined for, a function of
# the device giving (lmks, obs, mask, carry-start kwargs, params kwargs));
# each outcome is stated in tests/test_torch_gn_iter.py
def _base(device):
    prev, cur, mask, _ = case_inputs("noisy", device)
    return landmarks(prev), cur, mask


def _all_masked(device):
    lmks, cur, mask = _base(device)
    return lmks, cur, torch.zeros_like(mask), {}, {}


def _not_positive_definite(device):
    # every slot one landmark: H has rank 2, its Cholesky factor fails
    lmks, cur, mask = _base(device)
    return (lmks[:1].expand_as(lmks).contiguous(),
            cur[:1].expand_as(cur).contiguous(), mask, {}, {})


def _z_zero(device):
    # one landmark on the camera's plane after the increment's translation:
    # Z clamped to 1e-9, pixels ~1e12 and a Jacobian ~1e22, whose H
    # entries overflow the condition number's cap
    lmks, cur, mask = _base(device)
    lmks = lmks.clone()
    lmks[7, 2] = -0.3
    return lmks, cur, mask, dict(dp=[0, 0, 0, 0, 0, 0.3]), {}


def _non_finite(device):
    # a NaN landmark outside the mask: its slot's terms are 0 * NaN, which
    # poisons H and g as the plain version's sums are poisoned
    lmks, cur, mask = _base(device)
    lmks = lmks.clone()
    lmks[9, 0] = float("nan")
    mask = mask.clone()
    mask[9] = False
    return lmks, cur, mask, {}, {}


def _few_inliers(device):
    lmks, cur, mask = _base(device)
    return lmks, cur, mask & (torch.arange(len(mask), device=device) < 7), \
        {}, {}


def _cost_increase(device):
    # a later iteration whose cost rises over the last one's with
    # max_incr_cost 0: the cost-increase abort
    lmks, cur, mask = _base(device)
    return lmks, cur, mask, dict(dp=DEFAULT_POSE, it=2, cost=1e-3), dict(
        max_incr_cost=0)


def _condition_cap(device):
    # landmarks on one line through the camera: H positive definite but
    # nearly singular, its condition number over _COND_MAX (1e7)
    lmks, cur, mask = _base(device)
    s = torch.linspace(5.0, 40.0, len(mask), device=device)
    lmks = torch.stack([0.01 * s + 1e-3 * torch.sin(s), 0.02 * s,
                        s], -1).contiguous()
    return lmks, cur, mask, {}, {}


def _last_iteration(device):
    lmks, cur, mask = _base(device)
    return lmks, cur, mask, dict(it=9), {}


NO_LM = ("robust", "no_robust_kernel", "no_irls", "eigh")
DEGENERATE = {
    "all_masked": (tuple(VARIANTS), _all_masked),
    # LM damps a rank-deficient H into a positive definite one
    "not_positive_definite": (NO_LM, _not_positive_definite),
    # with LM no condition cap aborts it, and the damped step of an H of
    # norm ~1e33 (the LM eigh solve's abort, the sign of its smallest
    # eigenvalue, too) is its rounding
    "z_zero": (NO_LM, _z_zero),
    "non_finite_masked": (tuple(VARIANTS), _non_finite),
    "few_inliers": (tuple(VARIANTS), _few_inliers),
    "cost_increase": (tuple(VARIANTS), _cost_increase),
    "condition_cap": (NO_LM, _condition_cap),
    "last_iteration": (tuple(VARIANTS), _last_iteration),
}


def degenerate(name: str, variant: str, device="cpu", max_iters=10):
    """(lmks, obs, mask, carry, params) of a DEGENERATE case."""
    lmks, obs, mask, start, kw = DEGENERATE[name][1](device)
    p = params(variant, **kw)
    start = dict(dict(dp=[0.0] * 6), **start)
    return lmks, obs, mask, carry(len(mask), device=device, params=p,
                                  **start), p
