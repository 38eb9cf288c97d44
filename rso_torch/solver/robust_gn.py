"""Two-phase robust Gauss-Newton 6-DoF pose solver.

Counterpart of rso/solver/robust_gn.py `solve_pose` with the default
"chol" backend and IRLS Hessian weighting: phase 1 (<= initial_max_iters),
the residual-threshold outlier cut, phase 2 (<= max_iters) continuing from
phase 1's pose and cost-increase count, and the same VOEC_* codes.

The reference's `lax.while_loop` becomes a bounded Python loop with the same
exits.  It reads its stop flag back once per iteration: one host sync per GN
iteration, which this slice accepts.  The "eigh" backend and LM damping are
ROADMAP Queue 1 #8 leftovers and raise NotImplementedError.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from rso_torch.config import LeastSquaresParams
from rso_torch.geometry.se3 import pose_inverse
from rso_torch.geometry.stereo_camera import (
    StereoCamera,
    project_stereo_with_jacobian,
    triangulate,
)

# VOErrorCode (reference libstereo-odometry.h:142) + the rso extension 6
VOEC_NONE = 0
VOEC_BAD_TRACKING = 1
VOEC_BAD_COND_NUMBER = 2
VOEC_INCR_FUNC_COST_STG1 = 3
VOEC_INCR_FUNC_COST_STG2 = 4
VOEC_FIRST_ITERATION = 5
VOEC_TOO_FEW_INLIERS = 6

_COND_MAX = 1e7
_F32_MAX = torch.finfo(torch.float32).max


class PoseSolveResult(NamedTuple):
    pose: torch.Tensor          # [6] pose of current frame wrt previous
    delta_pose: torch.Tensor    # [6] raw optimised increment (w,t)
    valid: torch.Tensor         # bool
    error_code: torch.Tensor    # int32 VOEC_*
    num_it: torch.Tensor        # int32 phase-1 iterations
    num_it_final: torch.Tensor  # int32 phase-2 iterations
    residuals: torch.Tensor     # [N] squared pixel residual per slot
    inliers: torch.Tensor       # [N] bool final inlier mask
    cost: torch.Tensor          # final robust cost


def _eval_rgn(cam: StereoCamera, lmks, obs, mask, delta_pose,
              params: LeastSquaresParams, obs_weight=None):
    """One GN evaluation (reference m_evalRGN, stage5_optimization.cpp:275-390).
    Returns (dx [6], cost, residual_sq [N], bad_cond)."""
    pix, J = project_stereo_with_jacobian(cam, lmks, delta_pose)
    r = obs - pix
    s = (r * r).sum(-1)
    jac_ok = torch.isfinite(J).all(dim=2).all(dim=1) & torch.isfinite(pix).all(dim=1)
    m = mask & jac_ok
    mf = m.to(J.dtype)

    if params.use_robust_kernel:
        b2 = params.kernel_param * params.kernel_param
        n = torch.sqrt(1.0 + s / b2)
        rho_p = 1.0 / n                                 # pseudo-Huber derivative
        fi = b2 * (n - 1.0)
    else:
        rho_p = torch.ones_like(s)
        fi = 0.5 * s
    if obs_weight is not None:
        mf = mf * obs_weight
    cost = (mf * fi).sum()

    g = torch.einsum("n,nij,ni->j", mf * rho_p, J, r)
    h_w = mf * rho_p if params.irls_hessian_weighting else mf
    H = torch.einsum("n,nij,nik->jk", h_w, J, J)

    # Cholesky solve + cond_1 guard.  cholesky_ex reports a non-PD H in
    # `info` instead of raising (and syncing); it becomes NaN, as
    # jnp.linalg.cholesky reports it, so the guard below flags bad_cond.
    L, info = torch.linalg.cholesky_ex(H)
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    Hinv = torch.cholesky_solve(eye6, L)
    Hinv = torch.where(info == 0, Hinv, torch.full_like(Hinv, torch.nan))
    dx = Hinv @ g
    cond = H.abs().sum(0).amax() * Hinv.abs().sum(0).amax()
    bad_cond = (~torch.isfinite(cond) | ~torch.isfinite(dx).all()
                | (cond > _COND_MAX))
    dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
    s_out = torch.where(m, s, torch.full_like(s, _F32_MAX))
    return dx, cost, s_out, bad_cond


def _gn_phase(cam, lmks, obs, mask, delta_pose0, max_iters: int, times_inc0,
              params: LeastSquaresParams, incr_cost_code: int,
              obs_weight=None):
    """One of the two GN loops (reference :549-598 and :650-700)."""
    dev = obs.device
    dp = delta_pose0
    p_cost = torch.zeros((), dtype=torch.float32, device=dev)
    times_inc = (times_inc0 if isinstance(times_inc0, torch.Tensor) else
                 torch.full((), times_inc0, dtype=torch.int32, device=dev))
    abort = torch.zeros((), dtype=torch.bool, device=dev)
    res = torch.full((obs.shape[0],), _F32_MAX, dtype=torch.float32, device=dev)
    ec = torch.full((), VOEC_NONE, dtype=torch.int32, device=dev)
    cost = p_cost
    it = 0
    while it < max_iters:
        dx, c_cost, res, bad_cond = _eval_rgn(cam, lmks, obs, mask, dp, params,
                                              obs_weight)
        ec = torch.where(bad_cond, VOEC_BAD_COND_NUMBER, ec)
        dp = torch.where(bad_cond, dp, dp + dx)
        # ending conditions count from iteration 1 (reference :580-596)
        later = it > 0
        done = later & (torch.sqrt((dx * dx).sum()) < params.min_mod_out_vector)
        times_inc = times_inc + (later & (p_cost < c_cost)).to(torch.int32)
        too_many = times_inc > params.max_incr_cost
        ec = torch.where(too_many & ~bad_cond, incr_cost_code, ec)
        abort = bad_cond | too_many
        p_cost = cost = c_cost
        it += 1
        if bool(done | abort):          # the loop's one host sync
            break
    return (torch.full((), it, dtype=torch.int32, device=dev), dp, times_inc,
            abort, res, ec, cost)


def solve_pose(cam: StereoCamera, prev_obs: torch.Tensor,
               cur_obs: torch.Tensor, mask: torch.Tensor,
               params: LeastSquaresParams,
               initial_pose: torch.Tensor | None = None,
               obs_weight: torch.Tensor | None = None) -> PoseSolveResult:
    """Full two-phase robust GN pose solve on tracked stereo correspondences
    (the reference's getChangeInPose, common.cpp:355-413)."""
    if params.solve_backend != "chol":
        raise NotImplementedError(
            f"solve_backend={params.solve_backend!r}: only 'chol' is ported "
            "(the eigh backend is ROADMAP Queue 1 #8)")
    if params.use_lm:
        raise NotImplementedError("LM damping is ROADMAP Queue 1 #8")
    prev_obs = prev_obs.to(torch.float32)
    cur_obs = cur_obs.to(torch.float32)
    delta0 = (torch.zeros(6, dtype=torch.float32, device=cur_obs.device)
              if initial_pose is None else initial_pose.to(torch.float32))

    lmks = triangulate(cam, prev_obs[:, 0], prev_obs[:, 1], prev_obs[:, 2])
    enough = mask.sum() >= 8

    it1, dp1, times_inc, abort1, res1, ec1, _ = _gn_phase(
        cam, lmks, cur_obs, mask, delta0, params.initial_max_iters, 0, params,
        VOEC_INCR_FUNC_COST_STG1, obs_weight)

    inliers = mask & (res1 <= params.residual_threshold)
    enough2 = inliers.sum() >= 8

    it2, dp2, _, abort2, res2, ec2, cost2 = _gn_phase(
        cam, lmks, cur_obs, inliers, dp1, params.max_iters, times_inc, params,
        VOEC_INCR_FUNC_COST_STG2, obs_weight)

    valid = enough & enough2 & ~abort1 & ~abort2
    error_code = torch.where(ec1 != VOEC_NONE, ec1, ec2)
    error_code = torch.where((error_code == VOEC_NONE) & ~(enough & enough2),
                             VOEC_TOO_FEW_INLIERS, error_code).to(torch.int32)
    delta = torch.where(valid, dp2, dp1)
    return PoseSolveResult(
        pose=pose_inverse(delta),
        delta_pose=delta,
        valid=valid,
        error_code=error_code,
        num_it=it1,
        num_it_final=it2,
        residuals=res2,
        inliers=inliers & (res2 <= params.residual_threshold),
        cost=cost2,
    )
