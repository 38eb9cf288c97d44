"""Sliding-window stereo bundle adjustment via the Schur complement.

Counterpart of rso/ba/ba.py: jointly refine a window of keyframe poses and
the landmarks they observe, by Levenberg-Marquardt on the reduced camera
system.

Problem layout (fixed shapes, masked):
    poses   [P,6]   world->camera rotvec+translation per keyframe
    lmks    [L,3]   landmark positions (world frame)
    obs     [P,L,4] stereo observations (uL,vL,uR,vR)
    mask    [P,L]   observation validity

Every function here also takes leading batch dimensions (`[...,P,6]`,
`[...,L,3]`, ...): the batched window solve of rso_torch.ba.window_sharded
stacks independent windows along them, where the reference vmaps.  The
reference's einsums become batched GEMMs (cuBLAS on the card, in full f32:
rso_torch/__init__.py turns TF32 off), so sums run in another order than
XLA's and results differ from the reference by rounding
(tests/test_torch_ba.py states the tolerances).  No TPU kernel runs here:
the reference's solve is XLA ops too.

The reference's jax.jit + lax.while_loop becomes blocks of LM_BLOCK masked
LM iterations (an iteration after the stop changes nothing, so any block
size gives the same bits).  The eager loop reads the stop flag (a window
is still iterating and the loop is under max_iters) once per block but the
last; `solve_lm` captures the loop as one CUDA graph (pre, one block in a
conditional WHILE node that tests the flag on the device, tail) per shape
and per the Python scalars the graph bakes in, through
rso_torch.graphs.CompiledStep: no host read.  The mesh forms run
`solve_lm` with their `reduce`: on an NCCL group the graph holds the
all_reduces too (rso's jax.jit(shard_map(lax.while_loop + lax.psum))); on a
gloo group, whose collectives run on the host, the same solve runs eagerly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rso_torch.engine import _device
from rso_torch.geometry.rotations import rodrigues, rodrigues_with_grad
from rso_torch.geometry.stereo_camera import StereoCamera
from rso_torch.graphs import CompiledStep
from rso_torch.solver.robust_gn import eager_blocks

# masked LM iterations a block: one run of a WHILE node's body in the
# graph, one flag read in the eager form.  On an H100 (chip_smoke.py's
# LM_BLOCK_SWEEP in the one-launch graph, two calls): 5 wins on the bench
# problem's 15 iterations (15.22-15.41 ms a solve against 15.54-15.86 at 1
# and 16.37-17.05 at 2) and 1 on the 8 VOWithBA solves, which stop
# mid-block (148.2-168.7 ms against 170.9-176.7 at 5, its two passes in
# one call 20 ms apart); 5 stays, dividing every max_iters the port passes
# (15, 20, 25, 75)
LM_BLOCK = 5


class BAProblem(NamedTuple):
    poses: torch.Tensor      # [P,6] world->cam
    lmks: torch.Tensor       # [L,3]
    obs: torch.Tensor        # [P,L,4]
    mask: torch.Tensor       # [P,L] bool
    lmk_weight: torch.Tensor | None = None  # [L] observation down-weighting
    # (e.g. 2-view landmarks: geometrically valid but noise-dominated during
    # fast rotation — weighted, not dropped, so the problem never starves)


class BAResult(NamedTuple):
    poses: torch.Tensor
    lmks: torch.Tensor
    cost: torch.Tensor
    n_iters: torch.Tensor    # int32
    converged: torch.Tensor  # bool


def ba_problem_from_numpy(prob, device="cuda") -> BAProblem:
    """The reference's BAProblem, every leaf passed through np.asarray, as a
    BAProblem on `device` (the counterpart of engine.state_from_numpy; the
    GPU unless the caller passes "cpu", raising without CUDA)."""
    device = _device(device)

    def put(x, dtype):
        if x is None:
            return None
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return BAProblem(put(prob.poses, torch.float32),
                     put(prob.lmks, torch.float32),
                     put(prob.obs, torch.float32),
                     put(prob.mask, torch.bool),
                     put(prob.lmk_weight, torch.float32))


def _pixels(cam: StereoCamera, R, poses, lmks):
    """Camera-frame points of every landmark from every pose and their
    stereo pixels: (pix [...,P,L,4], X, Y, X2, Zs)."""
    Pt = torch.einsum("...pij,...lj->...pli", R, lmks) + poses[..., :, None, 3:]
    X, Y, Z = Pt.unbind(-1)
    Zs = torch.where(torch.abs(Z) < 1e-9, 1e-9, Z)
    X2 = X - cam.baseline
    pix = torch.stack([
        cam.fx_l * X / Zs + cam.cx_l,
        cam.fy_l * Y / Zs + cam.cy_l,
        cam.fx_r * X2 / Zs + cam.cx_r,
        cam.fy_r * Y / Zs + cam.cy_r,
    ], dim=-1)
    return pix, X, Y, X2, Zs


def _project_grid(cam: StereoCamera, poses, lmks):
    """Batched [P,L] stereo projection + Jacobians: pix [P,L,4], J_pose
    [P,L,4,6], J_lmk [P,L,4,3].  Rodrigues and dR/dw run once per pose."""
    R, dR = rodrigues_with_grad(poses[..., :3])              # [P,3,3],[P,3,3,3]
    pix, X, Y, X2, Zs = _pixels(cam, R, poses, lmks)

    # dP/dtheta: [P,L,6,3]; rotation rows dR_k @ X, translation identity
    dP_rot = torch.einsum("...pkij,...lj->...plki", dR, lmks)  # [P,L,3,3]
    eye = torch.eye(3, dtype=lmks.dtype, device=lmks.device).expand(dP_rot.shape)
    dP = torch.cat([dP_rot, eye], dim=-2)                     # [P,L,6,3]

    Z2 = (Zs * Zs)[..., None]
    Zse = Zs[..., None]

    def pix_rows(dPd):
        Xd, Yd, Zd = dPd.unbind(-1)
        return torch.stack([
            cam.fx_l * (Xd * Zse - X[..., None] * Zd) / Z2,
            cam.fy_l * (Yd * Zse - Y[..., None] * Zd) / Z2,
            cam.fx_r * (Xd * Zse - X2[..., None] * Zd) / Z2,
            cam.fy_r * (Yd * Zse - Y[..., None] * Zd) / Z2,
        ], dim=-1)                                            # [P,L,params,4]

    J_pose = pix_rows(dP).transpose(-1, -2)                   # [P,L,4,6]
    # landmark jacobian: dP/dX_j = column j of R -> rows of R^T
    RT = R.transpose(-1, -2)[..., :, None, :, :]
    RT = RT.expand(*R.shape[:-2], lmks.shape[-2], 3, 3)
    J_lmk = pix_rows(RT).transpose(-1, -2)                    # [P,L,4,3]
    return pix, J_pose, J_lmk


def inv3x3(M):
    """Closed-form batched 3x3 inverse (adjugate/det); a block with
    |det| < 1e-12 inverts to zero (its landmark does not move)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    tiny = torch.abs(det) < 1e-12
    safe = torch.where(tiny, 1.0, det)
    inv_det = torch.where(tiny, 0.0, 1.0 / safe)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _vee(M):
    """Inverse hat: the 3-vector of a (near-)skew-symmetric matrix."""
    return torch.stack([M[..., 2, 1] - M[..., 1, 2],
                        M[..., 0, 2] - M[..., 2, 0],
                        M[..., 1, 0] - M[..., 0, 1]], dim=-1) * 0.5


def _relpose_residuals(poses, rel_meas):
    """Consecutive-keyframe relative-pose residuals [P-1,6] of world->cam
    poses [P,6] against the VO-measured cam_p -> cam_{p+1} transforms
    rel_meas [P-1,6]: rotation vee(E - E^T)/2 (the log map to first order),
    translation the plain difference."""
    Ra = rodrigues(poses[..., :-1, :3])               # [P-1,3,3] W_p
    Rb = rodrigues(poses[..., 1:, :3])                # W_{p+1}
    ta, tb = poses[..., :-1, 3:], poses[..., 1:, 3:]
    # T_rel_est = W_{p+1} @ W_p^-1: R = Rb Ra^T, t = tb - Rb Ra^T ta
    R_rel = torch.einsum("...pij,...pkj->...pik", Rb, Ra)
    t_rel = tb - (R_rel * ta[..., None, :]).sum(-1)
    Rm = rodrigues(rel_meas[..., :3])
    E = torch.einsum("...pij,...pkj->...pik", R_rel, Rm)  # R_rel_est @ R_meas^T
    r_rot = _vee(E - E.transpose(-1, -2))
    r_t = t_rel - rel_meas[..., 3:]
    return torch.cat([r_rot, r_t], dim=-1)            # [P-1,6]


def _relpose_jacobian(poses, rel_meas):
    """d _relpose_residuals / d poses: [P-1,6,P,6], in closed form.

    Pair a couples poses a and b = a+1: with R_rel = R_b R_a^T and
    E = R_rel R_m^T, the rotation rows are vee(dE - dE^T) of
    dE = R_b dR_a^T R_m^T (w.r.t. w_a) and dR_b R_a^T R_m^T (w.r.t. w_b);
    the translation rows -dR_rel t_a w.r.t. the rotations, -R_rel w.r.t.
    t_a and the identity w.r.t. t_b.  dR/dw comes from rodrigues_with_grad,
    which at a zero rotation vector is the hat basis: finite, as the
    reference's forward-mode derivative (jax.jacfwd) is there.
    """
    R, dR = rodrigues_with_grad(poses[..., :3])
    Ra, Rb = R[..., :-1, :, :], R[..., 1:, :, :]
    ta = poses[..., :-1, 3:]
    Rm = rodrigues(rel_meas[..., :3])
    R_rel = torch.einsum("...pij,...pkj->...pik", Rb, Ra)
    # d R_rel / d w_k, k the [3] axis after the pair axis: [P-1,3,3,3]
    dRel_a = torch.einsum("...pij,...pkmj->...pkim", Rb, dR[..., :-1, :, :, :])
    dRel_b = torch.einsum("...pkij,...pmj->...pkim", dR[..., 1:, :, :, :], Ra)

    def rows(dRel):
        """[P-1,6,3]: the residual rows' derivatives w.r.t. one rotation."""
        dE = torch.einsum("...pkij,...pmj->...pkim", dRel, Rm)
        d_rot = torch.stack([dE[..., 2, 1] - dE[..., 1, 2],
                             dE[..., 0, 2] - dE[..., 2, 0],
                             dE[..., 1, 0] - dE[..., 0, 1]], dim=-1)
        d_t = -(dRel * ta[..., None, None, :]).sum(-1)
        return torch.cat([d_rot, d_t], dim=-1).transpose(-1, -2)

    zeros = torch.zeros_like(R_rel)
    eye = torch.eye(3, dtype=poses.dtype, device=poses.device).expand(R_rel.shape)
    J_a = torch.cat([rows(dRel_a), torch.cat([zeros, -R_rel], dim=-2)], dim=-1)
    J_b = torch.cat([rows(dRel_b), torch.cat([zeros, eye], dim=-2)], dim=-1)
    # place pair a's two blocks at poses a and a+1
    P = poses.shape[-2]
    pair = torch.arange(P - 1, device=poses.device)[:, None]
    pose = torch.arange(P, device=poses.device)[None, :]
    at_a = (pose == pair).to(poses.dtype)
    at_b = (pose == pair + 1).to(poses.dtype)
    return (torch.einsum("ap,...aij->...aipj", at_a, J_a)
            + torch.einsum("ap,...aij->...aipj", at_b, J_b))


def relpose_prior_terms(poses, rel_meas, w_rot, w_trans):
    """Gauss-Newton terms of the odometry prior: (H [P,6,P,6], g [P,6], cost).

    The prior anchors consecutive keyframes to their VO-measured relative
    motion.  H adds to the reduced camera system directly (pose-only), g
    follows the reprojection gradient's sign convention (x += H^-1 g).
    """
    W = torch.cat([torch.full((3,), w_rot, dtype=poses.dtype, device=poses.device),
                   torch.full((3,), w_trans, dtype=poses.dtype,
                              device=poses.device)])
    e = _relpose_residuals(poses, rel_meas)           # [P-1,6]
    J = _relpose_jacobian(poses, rel_meas)            # [P-1,6,P,6]
    # H[pj,ql] = sum_{a,i} J[a,i,p,j] W[i] J[a,i,q,l]
    H = torch.einsum("...aipj,...aiql->...pjql", J * W[:, None, None], J)
    g = -(J * (e * W)[..., None, None]).sum((-4, -3))
    cost = 0.5 * torch.sum(e * e * W, dim=(-2, -1))
    return H, g, cost


def _f32(x: float) -> float:
    """x rounded to float32, as the reference's traced f32 scalars are."""
    return float(np.float32(x))


def _robust_weights(r2, kernel_param, use_robust):
    if use_robust:
        b2 = float(np.float32(kernel_param) * np.float32(kernel_param))
        n = torch.sqrt(1.0 + r2 / b2)
        return 1.0 / n, b2 * (n - 1.0)
    return torch.ones_like(r2), 0.5 * r2


def ba_normal_equations(cam: StereoCamera, prob: BAProblem,
                        kernel_param: float = 3.0, use_robust: bool = True):
    """The BA normal-equation blocks: (cost, g_p [P,6], g_l [L,3], H_pp
    [P,6,6], H_ll [L,3,3], H_pl [P,L,6,3], r2 [P,L], m [P,L])."""
    pix, J_p, J_l = _project_grid(cam, prob.poses, prob.lmks)
    r = prob.obs - pix                                  # [P,L,4]
    r2 = torch.sum(r * r, dim=-1)

    finite = (torch.isfinite(pix).all(-1)
              & torch.isfinite(J_p).flatten(-2).all(-1)
              & torch.isfinite(J_l).flatten(-2).all(-1))
    m = (prob.mask & finite).to(r.dtype)                # [P,L]
    # explicitly zero non-finite terms: a masked weight of 0 times an inf
    # Jacobian entry would still produce NaN in the products
    mb = m[..., None] > 0
    r = torch.where(mb, r, 0.0)
    J_p = torch.where(mb[..., None], J_p, 0.0)
    J_l = torch.where(mb[..., None], J_l, 0.0)
    r2 = torch.where(m > 0, r2, 0.0)
    rho, fi = _robust_weights(r2, kernel_param, use_robust)
    if prob.lmk_weight is not None:
        m = m * prob.lmk_weight[..., None, :]
    w = m * rho

    cost = torch.sum(m * fi, dim=(-2, -1))
    g_p = torch.einsum("...pl,...plij,...pli->...pj", w, J_p, r)      # [P,6]
    g_l = torch.einsum("...pl,...plij,...pli->...lj", w, J_l, r)      # [L,3]
    # Hessian blocks (IRLS weighting on both, same fixed point)
    H_pp = torch.einsum("...pl,...plij,...plik->...pjk", w, J_p, J_p)  # [P,6,6]
    H_ll = torch.einsum("...pl,...plij,...plik->...ljk", w, J_l, J_l)  # [L,3,3]
    H_pl = torch.einsum("...pl,...plij,...plik->...pljk", w, J_p, J_l)  # [P,L,6,3]
    return cost, g_p, g_l, H_pp, H_ll, H_pl, r2, m


def _schur_solve(g_p, g_l, H_pp, H_ll, H_pl, lm_lambda, fix_first: bool,
                 lmk_valid, prior=None, reduce=None):
    """Schur-complement reduced camera solve + landmark back-substitution.

    Returns (dpose [P,6], dlmk [L,3]).  lm_lambda is a number or a tensor
    of the batch shape.  The [6P,6P] solve is an LU factorisation
    (torch.linalg.lu_factor_ex) with its status ignored: a singular system gives non-finite steps, which the
    LM loop rejects, as it does the reference's jnp.linalg.solve.  On an
    H100 with torch 2.11 the LU factorisation takes cuSOLVER's getrf for
    one window and cuBLAS's batched getrf for a batch, then two triangular
    solves (below).  All of it runs in a CUDA graph capture (no host sync,
    no memory node), so the eager loop and the graph run the same kernels.

    reduce: None on one device; with the landmarks sharded over a mesh,
    the sum over the shards of (g_p, H_pp, the Schur cross term, W g_l),
    the four landmark sums the reference psums (rso/ba/distributed.py:
    132-133, 146-148).  Everything after it is replicated.
    """
    P = g_p.shape[-2]
    dt, dev = g_p.dtype, g_p.device
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    lam = torch.as_tensor(lm_lambda, dtype=dt, device=dev)[..., None, None, None]

    # Marquardt damping (lam * diag(H)): scale-relative, bounding the
    # condition number of H_ll_d for the f32 adjugate inverse
    diag_ll = eye3 * H_ll.diagonal(0, -2, -1)[..., None, :]
    H_ll_d = H_ll + lam * diag_ll + 1e-6 * eye3
    # guard empty landmarks
    lv = lmk_valid.to(dt)[..., None, None]
    H_ll_d = H_ll_d * lv + (1 - lv) * eye3
    H_ll_inv = inv3x3(H_ll_d) * lv

    # W_l = H_pl H_ll^-1  [P,L,6,3]
    W = torch.einsum("...pljk,...lkm->...pljm", H_pl, H_ll_inv)
    # S = H_pp - sum_l W H_pl^T  (cross-pose blocks)  [P,P,6,6]
    cross = torch.einsum("...pljm,...qlkm->...pqjk", W, H_pl)
    # reduced gradient: g_p - sum_l W g_l
    Wg = (W * g_l[..., None, :, None, :]).sum((-3, -1))
    if reduce is not None:
        g_p, H_pp, cross, Wg = reduce(g_p, H_pp, cross, Wg)
    S = -cross
    diag = torch.arange(P, device=dev)
    S[..., diag, diag, :, :] += H_pp + lam * eye6
    b = g_p - Wg

    # odometry / marginalization prior (pose-only): add before the gauge fix
    if prior is not None:
        H_prior, g_prior = prior
        S = S + H_prior.transpose(-3, -2)             # [P,6,P,6]->[P,P,6,6]
        b = b + g_prior

    # gauge fix: freeze pose 0 (identity block, zero gradient)
    if fix_first:
        S[..., 0, :, :, :] = 0.0
        S[..., :, 0, :, :] = 0.0
        S[..., 0, 0, :, :] = eye6
        b[..., 0, :] = 0.0

    Sd = S.transpose(-3, -2).reshape(*S.shape[:-4], P * 6, P * 6)
    A = Sd + 1e-8 * torch.eye(P * 6, dtype=dt, device=dev)
    # A = P L U, and dpose = U^-1 L^-1 P^T b by two triangular solves of b
    # beside a zero column.  torch.linalg.solve's own solve of few
    # right-hand sides takes cuSOLVER's getrs, whose cuBLAS trsv may
    # allocate its scratch with cudaMallocAsync, recorded by a capture as
    # memory nodes that no conditional node's body takes; cuBLAS's trsm of
    # two columns does not
    LU, piv, _ = torch.linalg.lu_factor_ex(A)
    perm = torch.lu_unpack(LU, piv, unpack_data=False)[0].argmax(-2)
    rhs = b.reshape(*b.shape[:-2], P * 6).gather(-1, perm)[..., None]
    rhs = torch.cat([rhs, torch.zeros_like(rhs)], -1)
    rhs = torch.linalg.solve_triangular(LU, rhs, upper=False,
                                        unitriangular=True)
    dpose = torch.linalg.solve_triangular(LU, rhs, upper=True)
    dpose = dpose[..., 0].reshape(b.shape)

    # back-substitution: dlmk = H_ll^-1 (g_l - sum_p H_pl^T dpose_p)
    rhs = g_l - (H_pl * dpose[..., :, None, :, None]).sum((-4, -2))
    dlmk = torch.einsum("...ljk,...lk->...lj", H_ll_inv, rhs)
    return dpose, dlmk


def _all_finite(x, n_dims: int):
    return torch.isfinite(x).flatten(-n_dims).all(-1)


class LMCarry(NamedTuple):
    """The LM loop's carry: the reference's while-loop state, with one loop
    count `n` for the batch, each window's own count `it`, and the cap
    `n_max` (max_iters) that the loop's flag holds."""

    n: torch.Tensor        # int32 iterations the loop has run
    it: torch.Tensor       # [...] int32 iterations each window took
    poses: torch.Tensor
    lmks: torch.Tensor
    lam: torch.Tensor      # [...] damping
    cost: torch.Tensor     # [...]
    done: torch.Tensor     # [...] bool: converged, or a padding slot
    n_max: torch.Tensor    # int32 max_iters

    def stop_flag(self):
        """(HOST_READS site, device flag that is true while the loop runs:
        a window is left and the loop is under its cap, so that a loop
        tested only on the device stops where the eager one does)."""
        return "lm", (~self.done).any() & (self.n < self.n_max)


def levenberg_marquardt(cam: StereoCamera, prob: BAProblem, max_iters: int,
                        kernel_param: float, use_robust: bool,
                        fix_first: bool, init_lambda: float, tol: float,
                        rel_meas=None, rel_w_rot: float = 0.0,
                        rel_w_trans: float = 0.0, marg_prior=None,
                        reduce=None, active=None,
                        loop=eager_blocks) -> BAResult:
    """The LM loop over a problem with leading batch dimensions (none for
    one window), eagerly unless `loop` captures it (solve_lm).

    A window whose step is accepted and shorter than `tol`, or that has run
    `max_iters` iterations, keeps its whole carry (iteration count
    included) while the others go on, as the reference's vmapped
    while_loop does; the loop ends when no window is left.  `tol=0` runs
    exactly `max_iters` iterations.  A window where `active` (batch shape)
    is False starts done: a padding slot.  The iterations run in blocks of
    LM_BLOCK, `loop` reading the stop flag after each block but the last.

    reduce: None on one device.  Where `prob` holds this rank's shard of
    the landmarks, reduce(*tensors) returns each tensor summed over the
    shards (rso_torch.ba.distributed): it is called once for the normal
    equations' landmark sums and once for the cost with the count of
    non-finite landmarks, so every decision below is taken from reduced
    values and replicated poses, the same on every rank.  The pose-only
    priors are added after the reduction, once.
    """
    lmk_valid = prob.mask.any(-2)                       # [...,L]
    dt, dev = prob.poses.dtype, prob.poses.device
    use_prior = rel_meas is not None and (rel_w_rot > 0 or rel_w_trans > 0)
    if use_prior:
        W_rel = torch.cat([torch.full((3,), rel_w_rot, dtype=dt, device=dev),
                           torch.full((3,), rel_w_trans, dtype=dt, device=dev)])
    if marg_prior is not None:
        mH, mb, mlin = (torch.as_tensor(a, dtype=dt, device=dev)
                        for a in marg_prior)
        nP = prob.poses.shape[-2]
        mHf = mH.reshape(nP * 6, nP * 6)
        mbf = mb.reshape(-1)

    def marg_step(poses):
        dx = (poses - mlin).flatten(-2)
        return dx, (mHf * dx[..., None, :]).sum(-1)

    def eval_cost(poses, lmks, *extra):
        """The cost, and `extra` (landmark sums) reduced with it."""
        R, _ = rodrigues_with_grad(poses[..., :3])
        pix = _pixels(cam, R, poses, lmks)[0]
        r2 = torch.sum((prob.obs - pix) ** 2, dim=-1)
        _, fi = _robust_weights(r2, kernel_param, use_robust)
        m = (prob.mask & torch.isfinite(pix).all(-1)).to(fi.dtype)
        if prob.lmk_weight is not None:
            m = m * prob.lmk_weight[..., None, :]
        cost = torch.sum(m * fi, dim=(-2, -1))
        if reduce is not None:
            cost, *extra = reduce(cost, *extra)
        if use_prior:
            e = _relpose_residuals(poses, rel_meas)
            cost = cost + 0.5 * torch.sum(e * e * W_rel, dim=(-2, -1))
        if marg_prior is not None:
            dx, Hdx = marg_step(poses)
            cost = cost + 0.5 * (dx * Hdx).sum(-1) - (mbf * dx).sum(-1)
        return cost, *extra

    tol32 = _f32(tol)

    def iteration(c: LMCarry) -> LMCarry:
        poses, lmks = c.poses, c.lmks
        p = prob._replace(poses=poses, lmks=lmks)
        _c, g_p, g_l, H_pp, H_ll, H_pl, _r2, _m = ba_normal_equations(
            cam, p, kernel_param, use_robust)
        prior = None
        if use_prior:
            H_pr, g_pr, _ = relpose_prior_terms(poses, rel_meas, rel_w_rot,
                                                rel_w_trans)
            prior = (H_pr, g_pr)
        if marg_prior is not None:
            dx, Hdx = marg_step(poses)
            g_m = (mbf - Hdx).reshape(poses.shape)
            prior = (mH, g_m) if prior is None else (prior[0] + mH,
                                                     prior[1] + g_m)
        dpose, dlmk = _schur_solve(g_p, g_l, H_pp, H_ll, H_pl, c.lam,
                                   fix_first, lmk_valid, prior=prior,
                                   reduce=reduce)
        new_poses = poses + dpose
        new_lmks = lmks + dlmk * lmk_valid[..., None]
        n_bad = (~torch.isfinite(new_lmks)).flatten(-2).sum(
            -1, dtype=torch.float32)
        new_cost, n_bad = eval_cost(new_poses, new_lmks, n_bad)
        accept = ((new_cost < c.cost) & torch.isfinite(new_cost)
                  & _all_finite(new_poses, 2) & (n_bad == 0))
        step = torch.sqrt(torch.sum(dpose ** 2, dim=(-2, -1)))

        # windows still iterating take the step; an iteration past the
        # stop, or past max_iters, changes nothing
        live = ~c.done & (c.n < max_iters)
        take = live & accept
        new_lam = torch.where(accept, torch.clamp(c.lam * 0.3, min=1e-9),
                              torch.clamp(c.lam * 8.0, max=1e6))
        return LMCarry(
            n=c.n + 1,
            it=c.it + live.to(torch.int32),
            poses=torch.where(take[..., None, None], new_poses, poses),
            lmks=torch.where(take[..., None, None], new_lmks, lmks),
            lam=torch.where(live, new_lam, c.lam),
            cost=torch.where(take, new_cost, c.cost),
            done=c.done | (take & (step < tol32)),
            n_max=c.n_max)

    B = min(LM_BLOCK, max_iters)

    def block(c: LMCarry) -> LMCarry:
        for _ in range(B):
            c = iteration(c)
        return c

    batch = prob.poses.shape[:-2]
    cost, = eval_cost(prob.poses, prob.lmks)
    carry = LMCarry(
        n=torch.zeros((), dtype=torch.int32, device=dev),
        it=torch.zeros(batch, dtype=torch.int32, device=dev),
        poses=prob.poses, lmks=prob.lmks,
        lam=torch.full(batch, _f32(init_lambda), dtype=torch.float32,
                       device=dev),
        cost=cost,
        done=(torch.zeros(batch, dtype=torch.bool, device=dev)
              if active is None else ~active),
        n_max=torch.full((), max_iters, dtype=torch.int32, device=dev))
    c = loop(block, carry, -(-max_iters // B) if max_iters > 0 else 0)
    return BAResult(poses=c.poses, lmks=c.lmks, cost=c.cost, n_iters=c.it,
                    converged=c.done)


# the compiled LM solves of this process, by the values their graphs bake in
# (the counterpart of rso's jit cache of bundle_adjust)
_SOLVES: dict = {}


def solve_lm(cam: StereoCamera, prob: BAProblem, max_iters: int,
             kernel_param: float, use_robust: bool, fix_first: bool,
             init_lambda: float, tol: float, rel_meas=None,
             rel_w_rot: float = 0.0, rel_w_trans: float = 0.0,
             marg_prior=None, active=None, reduce=None) -> BAResult:
    """levenberg_marquardt as a compiled solve, the counterpart of rso's
    jax.jit + lax.while_loop: a CompiledStep per (device, Python scalars,
    LM_BLOCK, the optional inputs given, the group and axis of `reduce`),
    which keys its static buffers and graphs by the inputs' shapes.  On the
    GPU the solve is one CUDA graph launch (pre, one block of LM_BLOCK
    iterations in a WHILE node run while the stop flag is true, tail),
    captured at the first call of each key and shape after an eager warm-up
    that is that call's answer; on the CPU the same object runs eagerly
    through the same buffers.  The inputs are copied into the static
    buffers and the result out of them, so a later solve never changes an
    earlier result.  Any block size gives the same bits (an iteration past
    the stop changes nothing).  A capture that fails raises.

    reduce: None on one device; on a mesh (rso_torch.mesh.AllReduce), the
    landmark sums of the loop over the ranks holding `prob`'s shards, and
    the result's landmarks gathered over them in the tail (every rank's
    slice in rank order).  A captured all_reduce bakes in its group's
    communicator, so the key names the group.  On an NCCL group the graph
    holds the all_reduces (the warm-up has created the communicator); on a
    gloo group, whose collectives run on the host and cannot be captured,
    the solve runs eagerly through the same buffers, one stop-flag read a
    block (`AllReduce.capturable`).  Every rank takes the loop's decisions
    from reduced or replicated values, so every rank runs the same blocks
    and collectives."""
    dev = prob.poses.device
    key = (dev, max_iters, float(kernel_param), bool(use_robust),
           bool(fix_first), float(init_lambda), float(tol), float(rel_w_rot),
           float(rel_w_trans), LM_BLOCK,
           tuple(x is None for x in (rel_meas, marg_prior, active,
                                     prob.lmk_weight)),
           None if reduce is None else (reduce.group, reduce.axis))
    solve = _SOLVES.get(key)
    if solve is None:
        def fn(_state, cam, prob, rel_meas, marg_prior, active, *, loop):
            out = levenberg_marquardt(
                cam, prob, max_iters, kernel_param, use_robust, fix_first,
                init_lambda, tol, rel_meas, rel_w_rot, rel_w_trans,
                marg_prior, reduce=reduce, active=active, loop=loop)
            if reduce is not None:
                out = out._replace(lmks=reduce.gather(out.lmks, -2))
            return None, out

        capture = dev.type == "cuda" and (reduce is None
                                          or reduce.capturable)
        solve = _SOLVES[key] = CompiledStep(fn, capture=capture, site="lm")
    if marg_prior is not None:
        # host arrays reach the device here, outside any graph
        marg_prior = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                           for a in marg_prior)
    return solve(None, cam.to(dev), prob, rel_meas, marg_prior, active)[1]


def bundle_adjust(
    cam: StereoCamera,
    prob: BAProblem,
    max_iters: int = 20,
    kernel_param: float = 3.0,
    use_robust: bool = True,
    fix_first: bool = True,
    init_lambda: float = 1e-4,
    tol: float = 1e-5,
    rel_meas=None,
    rel_w_rot: float = 0.0,
    rel_w_trans: float = 0.0,
    marg_prior=None,
) -> BAResult:
    """Levenberg-Marquardt BA over one window, on the device of `prob`, as
    a compiled solve (solve_lm: CUDA graphs on the GPU).

    rel_meas [P-1,6] + rel_w_rot/rel_w_trans enable the odometry prior: each
    consecutive keyframe pair is softly anchored to its VO-measured relative
    transform (see relpose_prior_terms).  Weights are inverse variances in
    (rad, m) against 1-px reprojection noise.

    marg_prior: optional (H [P,6,P,6], b [P,6], lin [P,6]) marginalization
    prior from keyframe eviction (rso_torch.ba.marginalization /
    SlidingWindow.prior_terms), cast to float32: cost += 0.5 dx^T H dx -
    b^T dx with dx = poses - lin; its Hessian adds to the reduced camera
    system, its gradient b - H dx to the reduced gradient.
    """
    dev = prob.poses.device
    if rel_meas is not None:
        rel_meas = torch.as_tensor(rel_meas, dtype=torch.float32, device=dev)
    return solve_lm(cam, prob, max_iters, kernel_param, use_robust, fix_first,
                    init_lambda, tol, rel_meas, rel_w_rot, rel_w_trans,
                    marg_prior)
