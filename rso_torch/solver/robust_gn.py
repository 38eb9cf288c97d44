"""Two-phase robust Gauss-Newton 6-DoF pose solver.

Counterpart of rso/solver/robust_gn.py `solve_pose`: phase 1 (<=
initial_max_iters), the residual-threshold outlier cut, phase 2 (<=
max_iters) continuing from phase 1's pose and cost-increase count, and the
same VOEC_* codes.  Both solve backends ("chol", the default, and "eigh",
the reference's JacobiSVD semantics) and Levenberg-Marquardt damping
(`use_lm`) are here.

The reference's `lax.while_loop` becomes blocks of GN_BLOCK masked
iterations: an iteration after the stop (converged, aborted or out of
iterations) changes nothing, so the counts and the answer are the while
loop's whatever the block size.  A `loop` runner runs the blocks:
`eager_blocks` here, which reads the stop flag back once per block and not
after the last one, or the engine's compiled step, which captures one block
as the body of a CUDA graph's conditional WHILE node that tests the flag on
the device (rso_torch.graphs).  The flag (`active`) already holds the
iteration cap, so it is false after the last block.

Under torch.func.vmap (the batched engine step) the solve runs for every
lane at once, and the flag passes through `any_lane`, whose vmap rule
reduces it over the lanes: the loop runs while any lane runs, as rso's vmap
of `lax.while_loop` does, and a lane that has stopped is left unchanged by
the masked iterations.  The carry is made from the observations
(`*_like`), so under vmap every leaf has the lanes' axis from the start.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from rso_torch.config import LeastSquaresParams
from rso_torch.geometry.se3 import pose_inverse
from rso_torch.geometry.stereo_camera import (
    StereoCamera,
    project_stereo_with_jacobian,
    triangulate,
)
from rso_torch.kernels.eigh6 import eigh6_cuda

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

# masked GN iterations a block: one run of a WHILE node's body in the
# graph, one flag read in the eager form.  On an H100 (chip_smoke.py's
# GN_BLOCK_SWEEP, default and kitti paths, in the one-launch graph with no
# read to save): blocks of 1 and 2 tie (7.21 / 7.24 ms a default step,
# 9.63 / 9.65 kitti) and 4 loses (8.12, 11.27), its masked iterations
# costing more than the fewer WHILE iterations save; 1 also wins on wall
# time (7.53 against 7.94 ms) and runs no masked iteration
GN_BLOCK = 1

# host reads of device flags, by site: "gn" (the pose solver's stop flag,
# once per GN block but the last), "lm" (bundle adjustment's, once per LM
# block but the last: rso_torch.ba.ba) and "detect_every" (the engine's
# choice between detecting and propagating)
HOST_READS: collections.Counter = collections.Counter()


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
              params: LeastSquaresParams, obs_weight=None, lm_lambda=None):
    """One GN evaluation (reference m_evalRGN, stage5_optimization.cpp:275-390).
    `lm_lambda` adds Marquardt damping.  Returns (dx [6], cost, residual_sq
    [N], bad_cond)."""
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

    if lm_lambda is not None:
        # Marquardt damping: lambda * diag(H) keeps the step scale-relative
        H = H + lm_lambda * torch.diag(torch.diagonal(H))

    if params.solve_backend == "chol":
        # Cholesky solve + cond_1 guard.  cholesky_ex reports a non-PD H in
        # `info` instead of raising (and syncing); it becomes NaN, as
        # jnp.linalg.cholesky reports it, so the guard below flags bad_cond.
        L, info = torch.linalg.cholesky_ex(H)
        Hinv = cho_inverse(L)
        Hinv = torch.where(info == 0, Hinv, torch.full_like(Hinv, torch.nan))
        dx = Hinv @ g
        cond = H.abs().sum(0).amax() * Hinv.abs().sum(0).amax()
        bad_cond = ~torch.isfinite(cond) | ~torch.isfinite(dx).all()
        if lm_lambda is None:
            bad_cond = bad_cond | (cond > _COND_MAX)
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
    else:
        # symmetric eigendecomposition (the reference's JacobiSVD spectrum,
        # :375-388; `_eigh`).  LAPACK rejects a non-finite matrix where
        # jnp.linalg.eigh returns NaN: such an H is swapped for the identity
        # and its condition number set to NaN, which flags bad_cond as NaN
        # eigenvalues do in the reference.  Eigenvector signs may differ
        # from the reference's; dx does not depend on them.
        finite = torch.isfinite(H).all()
        eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
        w, V = _eigh(torch.where(finite, H, eye6))   # ascending
        cond = w[5] / torch.where(w[0] <= 0.0, torch.nan, w[0])
        cond = torch.where(finite, cond, torch.nan)
        # LM handles ill-conditioning by damping and aborts only on NaN
        # (the reference's own abort condition, :380-386)
        bad_cond = ~torch.isfinite(cond)
        if lm_lambda is None:
            bad_cond = bad_cond | (cond > _COND_MAX)
        w_inv = torch.where(w > w[5] * 1e-9,
                            1.0 / torch.where(w > 0, w, torch.ones_like(w)),
                            torch.zeros_like(w))
        dx = V @ (w_inv * (V.T @ g))
    s_out = torch.where(m, s, torch.full_like(s, _F32_MAX))
    return dx, cost, s_out, bad_cond


def _eigh(H: torch.Tensor):
    """(w ascending, V) of a symmetric 6x6 H: LAPACK's eigh on the CPU, the
    routine the reference's jnp.linalg.eigh runs there; on the GPU the
    eigh6 kernel (cyclic Jacobi), since cuSOLVER's eigh reads its status on
    the host and so cannot run inside the step's CUDA graph."""
    if H.device.type == "cpu":
        return torch.linalg.eigh(H)
    return eigh6_cuda(H)


def cho_inverse(L: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 from a [..., 6, 6] Cholesky factor L: two triangular
    solves of the identity (LAPACK's trsm on the CPU, cuBLAS's on the GPU).
    Unlike cholesky_solve, they run in a CUDA graph capture (cuSOLVER's
    potrs allocates with cudaMallocAsync, recorded as memory nodes that no
    conditional node's body takes; the batched form, MAGMA, cannot be
    captured at all), and they batch under torch.func.vmap."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    lower = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.solve_triangular(L.mT, lower, upper=True)


class GNCarry(NamedTuple):
    """The GN loop's carry: the reference's while-loop state plus `active`,
    the loop's condition (it < max_iters, not done, not aborted)."""

    it: torch.Tensor          # int32 iterations run
    active: torch.Tensor      # bool
    dp: torch.Tensor          # [6] pose increment
    cost: torch.Tensor        # last robust cost (the next iteration's pCost)
    times_inc: torch.Tensor   # int32 cost increases
    abort: torch.Tensor       # bool
    res: torch.Tensor         # [N] squared residuals of the last iteration
    ec: torch.Tensor          # int32 VOEC_*
    lam: torch.Tensor | None  # LM damping (None without LM)

    def stop_flag(self):
        """(HOST_READS site, device flag that is true while the loop runs,
        for every lane under vmap)."""
        return "gn", any_lane(self.active)


@torch.library.custom_op("rso_torch::any_lane", mutates_args=(),
                         schema="(Tensor flag) -> Tensor")
def any_lane(flag: torch.Tensor) -> torch.Tensor:
    """A loop's stop flag for all lanes: outside vmap a copy of `flag`;
    under torch.func.vmap (its rule) whether any lane's flag is set, as one
    flag with no lanes' axis, which the host can read."""
    return flag.clone()


@torch.library.register_vmap("rso_torch::any_lane")
def _any_lane_lanes(info, in_dims, flag):
    d = in_dims[0]
    return (flag.clone() if d is None else flag.any(dim=d)), None


def read_flag(site: str, running: torch.Tensor) -> bool:
    """A loop's stop flag read back to the host (the loop's one read a
    block), counted under its HOST_READS site."""
    HOST_READS[site] += 1
    return bool(running)


def stops_after(carry, b: int, n_blocks: int) -> bool:
    """Whether the loop ends after block b: at its last block, else where
    the carry's stop flag says so."""
    if b + 1 == n_blocks:
        return True
    return not read_flag(*carry.stop_flag())


def eager_blocks(block, carry, n_blocks: int):
    """Run up to `n_blocks` blocks of the loop."""
    for b in range(n_blocks):
        carry = block(carry)
        if stops_after(carry, b, n_blocks):
            break
    return carry


def _gn_phase(cam, lmks, obs, mask, delta_pose0, max_iters: int, times_inc0,
              params: LeastSquaresParams, incr_cost_code: int,
              obs_weight=None, loop=eager_blocks):
    """One of the two GN loops (reference :549-598 and :650-700); with
    `params.use_lm` the LM loop (:160-213), whose lambda halves after a
    step that did not raise the cost and quadruples after one that did."""

    def iteration(c: GNCarry) -> GNCarry:
        dx, c_cost, res, bad_cond = _eval_rgn(cam, lmks, obs, mask, c.dp,
                                              params, obs_weight,
                                              lm_lambda=c.lam)
        lam = c.lam
        if lam is not None:
            improved = (c.it == 0) | (c_cost <= c.cost)
            lam = torch.where(improved, torch.clamp(lam * 0.5, min=1e-7),
                              torch.clamp(lam * 4.0, max=1e3))
        ec = torch.where(bad_cond, VOEC_BAD_COND_NUMBER, c.ec)
        dp = torch.where(bad_cond, c.dp, c.dp + dx)
        # ending conditions count from iteration 1 (reference :580-596)
        later = c.it > 0
        done = later & (torch.sqrt((dx * dx).sum()) < params.min_mod_out_vector)
        times_inc = c.times_inc + (later & (c.cost < c_cost)).to(torch.int32)
        too_many = times_inc > params.max_incr_cost
        ec = torch.where(too_many & ~bad_cond, incr_cost_code, ec)
        abort = bad_cond | too_many
        it = c.it + c.active.to(torch.int32)
        new = GNCarry(it=it, active=c.active & ~done & ~abort & (it < max_iters),
                      dp=dp, cost=c_cost, times_inc=times_inc, abort=abort,
                      res=res, ec=ec, lam=lam)
        # an iteration after the stop changes nothing
        return GNCarry(*(None if n is None else torch.where(c.active, n, o)
                         for n, o in zip(new, c)))

    B = min(GN_BLOCK, max_iters)

    def block(c: GNCarry) -> GNCarry:
        for _ in range(B):
            c = iteration(c)
        return c

    # every leaf from the observations, so that under vmap each has the
    # lanes' axis that the blocks' in-place writes need
    zero = torch.zeros_like(obs[0, 0])
    carry = GNCarry(
        it=torch.zeros_like(zero, dtype=torch.int32),
        active=torch.full_like(zero, max_iters > 0, dtype=torch.bool),
        dp=torch.where(torch.ones_like(zero, dtype=torch.bool), delta_pose0,
                       zero),
        cost=zero,
        times_inc=(times_inc0 if isinstance(times_inc0, torch.Tensor) else
                   torch.full_like(zero, times_inc0, dtype=torch.int32)),
        abort=torch.zeros_like(zero, dtype=torch.bool),
        res=torch.full_like(obs[:, 0], _F32_MAX),
        ec=torch.full_like(zero, VOEC_NONE, dtype=torch.int32),
        lam=(torch.full_like(zero, params.lm_init_lambda)
             if params.use_lm else None))
    c = loop(block, carry, -(-max_iters // B) if max_iters > 0 else 0)
    return c.it, c.dp, c.times_inc, c.abort, c.res, c.ec, c.cost


def solve_pose(cam: StereoCamera, prev_obs: torch.Tensor,
               cur_obs: torch.Tensor, mask: torch.Tensor,
               params: LeastSquaresParams,
               initial_pose: torch.Tensor | None = None,
               obs_weight: torch.Tensor | None = None,
               loop=eager_blocks) -> PoseSolveResult:
    """Full two-phase robust GN pose solve on tracked stereo correspondences
    (the reference's getChangeInPose, common.cpp:355-413).  `loop` runs the
    GN blocks (eager_blocks)."""
    prev_obs = prev_obs.to(torch.float32)
    cur_obs = cur_obs.to(torch.float32)
    delta0 = (torch.zeros(6, dtype=torch.float32, device=cur_obs.device)
              if initial_pose is None else initial_pose.to(torch.float32))

    lmks = triangulate(cam, prev_obs[:, 0], prev_obs[:, 1], prev_obs[:, 2])
    enough = mask.sum() >= 8

    it1, dp1, times_inc, abort1, res1, ec1, _ = _gn_phase(
        cam, lmks, cur_obs, mask, delta0, params.initial_max_iters, 0, params,
        VOEC_INCR_FUNC_COST_STG1, obs_weight, loop)

    inliers = mask & (res1 <= params.residual_threshold)
    enough2 = inliers.sum() >= 8

    it2, dp2, _, abort2, res2, ec2, cost2 = _gn_phase(
        cam, lmks, cur_obs, inliers, dp1, params.max_iters, times_inc, params,
        VOEC_INCR_FUNC_COST_STG2, obs_weight, loop)

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
