"""Keyframe marginalization: turn evicted information into a Gaussian prior.

A copy of rso/ba/marginalization.py (host numpy/scipy in float64, at
keyframe rate): importing anything under `rso` loads jax, which the port
never does.  The one change: `marginalize_oldest` reads the camera's nine
floats to the host once (`host_camera`), where the reference reads a
float per use; on a camera held on the GPU each read would be a sync.

Plain eviction (marginalize-by-drop) discards every constraint the oldest
keyframe carried; proper marginalization Schur-eliminates the evicted pose
and the landmarks that die with it, leaving a dense quadratic prior over the
remaining window poses that is added to every subsequent bundle adjustment.

What gets absorbed on eviction of keyframe 0 (window of P keyframes):
  1. all reprojection factors of DYING landmarks — those observed by >=
     `min_obs` keyframes pre-eviction but < `min_obs` after (they leave the
     active problem forever, so absorbing every one of their observations
     double-counts nothing),
  2. the odometry relative-pose factor between keyframe 0 and keyframe 1
     (the per-solve odometry prior only covers consecutive pairs *inside*
     the window, so this pair's factor would otherwise vanish),
  3. the previous marginalization prior (its keyframe-0 block is eliminated
     along with the pose).
Keyframe 0's observations of SURVIVING landmarks are dropped: those
landmarks stay active, and absorbing their factors while the remaining
keyframes keep re-observing them would double-count information.

The algebra (projection Jacobians, robust IRLS weights, residual sign and
gradient conventions) mirrors rso_torch.ba.ba so the prior composes with
the solver's normal equations.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_SMALL = 1e-5


def host_camera(cam):
    """The camera with its nine entries as Python floats, read from the
    device in one transfer (a camera of floats is returned as it is)."""
    if not isinstance(cam.fx_l, torch.Tensor):
        return cam
    return type(cam)(*torch.stack(list(cam)).tolist())


class MargPrior(NamedTuple):
    """Quadratic prior over the first `n` window keyframe poses.

    cost(x) = 0.5 dx^T H dx - b^T dx,  dx = x - lin  (x: stacked [n,6]
    world->cam rotvec+translation).  In the solver's descent convention the
    prior contributes Hessian H and gradient b - H dx.
    """

    H: np.ndarray    # [n*6, n*6] float64, symmetric PSD
    b: np.ndarray    # [n*6] float64
    lin: np.ndarray  # [n,6] float64 linearization point

    @property
    def n(self) -> int:
        return self.lin.shape[0]


def zero_prior(n: int) -> MargPrior:
    return MargPrior(H=np.zeros((n * 6, n * 6)), b=np.zeros(n * 6),
                     lin=np.zeros((n, 6)))


# ---------------------------------------------------------------------------
# numpy geometry (f64 mirror of rso_torch.geometry.rotations / rso_torch.ba.ba)
# ---------------------------------------------------------------------------

def _hat(w):
    return np.array([[0.0, -w[2], w[1]],
                     [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


def _rodrigues_np(w):
    """R, dR[k]=dR/dw_k — same formula/branch as rso_torch.geometry.rotations."""
    t2 = float(w @ w)
    t = np.sqrt(t2)
    K = _hat(w)
    E = np.stack([_hat(e) for e in np.eye(3)])
    if t < _SMALL:
        return np.eye(3) + K, E
    u = (1.0 - np.cos(t)) / t2
    v = np.sin(t) / t
    du = ((np.sin(t) / t) * t2 - (1.0 - np.cos(t)) * 2.0) / (t2 * t2) * w
    dv = (t * np.cos(t) - np.sin(t)) / (t2 * t) * w
    K2 = K @ K
    R = np.eye(3) + v * K + u * K2
    dK2 = np.einsum("kij,jl->kil", E, K) + np.einsum("ij,kjl->kil", K, E)
    dR = (dv[:, None, None] * K[None] + v * E
          + du[:, None, None] * K2[None] + u * dK2)
    return R, dR


def _project_np(cam, pose6, X):
    """Stereo projection of [D,3] landmarks from one pose with Jacobians.

    Returns pix [D,4], J_pose [D,4,6], J_lmk [D,4,3] — the f64 mirror of
    rso_torch.ba.ba._project_grid for a single pose.
    """
    R, dR = _rodrigues_np(np.asarray(pose6[:3], np.float64))
    t = np.asarray(pose6[3:], np.float64)
    P = X @ R.T + t                                  # [D,3]
    x, y, z = P[:, 0], P[:, 1], P[:, 2]
    zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
    x2 = x - float(cam.baseline)
    fx_l, fy_l = float(cam.fx_l), float(cam.fy_l)
    cx_l, cy_l = float(cam.cx_l), float(cam.cy_l)
    fx_r, fy_r = float(cam.fx_r), float(cam.fy_r)
    cx_r, cy_r = float(cam.cx_r), float(cam.cy_r)

    pix = np.stack([fx_l * x / zs + cx_l, fy_l * y / zs + cy_l,
                    fx_r * x2 / zs + cx_r, fy_r * y / zs + cy_r], axis=-1)

    dP_rot = np.einsum("kij,dj->dki", dR, X)          # [D,3(param),3]
    eye = np.broadcast_to(np.eye(3), (X.shape[0], 3, 3))
    dP = np.concatenate([dP_rot, eye], axis=1)        # [D,6,3]

    def rows(dPd):                                     # dPd [D,q,3]
        xd, yd, zd = dPd[..., 0], dPd[..., 1], dPd[..., 2]
        z2 = (zs * zs)[:, None]
        zse = zs[:, None]
        return np.stack([
            fx_l * (xd * zse - x[:, None] * zd) / z2,
            fy_l * (yd * zse - y[:, None] * zd) / z2,
            fx_r * (xd * zse - x2[:, None] * zd) / z2,
            fy_r * (yd * zse - y[:, None] * zd) / z2,
        ], axis=-1)                                    # [D,q,4]

    J_pose = np.swapaxes(rows(dP), 1, 2)               # [D,4,6]
    RT = np.broadcast_to(R.T, (X.shape[0], 3, 3))
    J_lmk = np.swapaxes(rows(RT), 1, 2)                # [D,4,3]
    return pix, J_pose, J_lmk


def _pose6_from_wc(T_wc):
    """world->cam (rotvec, t) from a camera-to-world matrix, f64."""
    from scipy.spatial.transform import Rotation

    R_cw = np.asarray(T_wc, np.float64)[:3, :3].T
    t_cw = -R_cw @ np.asarray(T_wc, np.float64)[:3, 3]
    return np.concatenate([Rotation.from_matrix(R_cw).as_rotvec(), t_cw])


def _triangulate_np(cam, ob):
    """Closed-form stereo back-projection (reference stage5:519-544), f64.
    Returns the camera-frame point or None when the disparity denominator
    vanishes."""
    fx_l, cx_l, cy_l = float(cam.fx_l), float(cam.cx_l), float(cam.cy_l)
    fx_r, cx_r = float(cam.fx_r), float(cam.cx_r)
    ul, vl, ur = float(ob[0]), float(ob[1]), float(ob[2])
    denom = fx_l * (cx_r - ur) + fx_r * (ul - cx_l)
    if abs(denom) < 1e-9:
        return None
    b_d = float(cam.baseline) / denom
    return np.array([b_d * fx_r * (ul - cx_l), b_d * fx_r * (vl - cy_l),
                     b_d * fx_l * fx_r])


def _relpose_residual_np(pa, pb, rel_meas):
    """f64 mirror of rso_torch.ba.ba._relpose_residuals for ONE pose pair."""
    Ra, _ = _rodrigues_np(pa[:3])
    Rb, _ = _rodrigues_np(pb[:3])
    R_rel = Rb @ Ra.T
    t_rel = pb[3:] - R_rel @ pa[3:]
    Rm, _ = _rodrigues_np(np.asarray(rel_meas[:3], np.float64))
    E = R_rel @ Rm.T
    r_rot = 0.5 * np.array([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0],
                            E[1, 0] - E[0, 1]])
    return np.concatenate([r_rot, t_rel - rel_meas[3:]])


def _relpose_jacobian_np(pa, pb, rel_meas, eps=1e-7):
    """Central finite-difference Jacobian [6,12] of the relative-pose
    residual wrt (pa, pb).  f64 central differences at 1e-7 give ~1e-9
    accuracy — ample for a prior term."""
    J = np.zeros((6, 12))
    x = np.concatenate([pa, pb])
    for k in range(12):
        xp, xm = x.copy(), x.copy()
        xp[k] += eps
        xm[k] -= eps
        rp = _relpose_residual_np(xp[:6], xp[6:], rel_meas)
        rm = _relpose_residual_np(xm[:6], xm[6:], rel_meas)
        J[:, k] = (rp - rm) / (2.0 * eps)
    return J


# ---------------------------------------------------------------------------
# Schur marginalization core
# ---------------------------------------------------------------------------

def schur_marginalize(H, b, keep):
    """Eliminate the variables where ~keep from (H, b).

    H' = Hkk - Hkm Hmm^-1 Hmk,  b' = bk - Hkm Hmm^-1 bm — the information
    form of Gaussian marginalization.  Hmm gets a tiny relative damping so
    unconstrained marginalized directions (e.g. a landmark only weakly
    observed) contribute nothing instead of blowing up.
    """
    keep = np.asarray(keep, bool)
    kk = np.ix_(keep, keep)
    km = np.ix_(keep, ~keep)
    mm = np.ix_(~keep, ~keep)
    Hmm = H[mm]
    n_m = Hmm.shape[0]
    if n_m == 0:
        return H[kk].copy(), b[keep].copy()
    damp = 1e-9 * max(np.trace(Hmm) / max(n_m, 1), 1.0)
    Hmm_d = Hmm + damp * np.eye(n_m)
    sol = np.linalg.solve(Hmm_d, np.concatenate([H[km].T, b[~keep][:, None]],
                                                axis=1))
    Hp = H[kk] - H[km] @ sol[:, :-1]
    bp = b[keep] - H[km] @ sol[:, -1]
    Hp = 0.5 * (Hp + Hp.T)
    return Hp, bp


def _psd_project(H, eig_floor=0.0):
    """Clip negative eigenvalues introduced by f64 roundoff."""
    w, V = np.linalg.eigh(H)
    w = np.maximum(w, eig_floor)
    return (V * w) @ V.T


# ---------------------------------------------------------------------------
# Keyframe eviction -> new prior
# ---------------------------------------------------------------------------

def marginalize_oldest(
    cam,
    keyframes,                    # pre-eviction list; keyframes[0] is evicted
    prior: MargPrior | None,
    min_obs: int = 2,
    two_view_weight: float = 0.2,
    kernel_param: float = 3.0,
    rel_w: tuple[float, float] = (0.0, 0.0),
    max_dying: int = 1024,
    anchor_w: tuple[float, float] = (1.0e4, 1.0e3),
) -> MargPrior:
    """Build the post-eviction prior over keyframes[1:]. See module doc.

    anchor_w (rot, trans): absolute gauge anchor added to the evicted pose
    at the FIRST eviction of the chain (prior is None).  Without it every
    absorbed factor is relative (reprojection, odometry), whose marginal
    onto the surviving poses is gauge-null — mathematically zero.  Rooting
    the chain in an absolute anchor (as DSO's first-frame gauge prior does)
    lets each eviction transfer absolute information forward, so the prior
    actually stiffens old window poses against their history.
    """
    from collections import Counter

    cam = host_camera(cam)
    P = len(keyframes)
    assert P >= 2
    n_vars = P * 6
    poses = np.stack([_pose6_from_wc(kf.pose_wc) for kf in keyframes])

    # --- dying landmark set ---------------------------------------------
    pre = Counter()
    for kf in keyframes:
        pre.update(int(i) for i in kf.ids)
    post = Counter()
    for kf in keyframes[1:]:
        post.update(int(i) for i in kf.ids)
    dying = [i for i, c in pre.items()
             if c >= min_obs and post.get(i, 0) < min_obs]
    dying = dying[:max_dying]
    slot = {i: d for d, i in enumerate(dying)}
    D = len(dying)

    # world positions: triangulate from the first observing keyframe
    lmk_w = np.zeros((D, 3))
    lmk_ok = np.zeros(D, bool)
    obs_by_pose: list[list] = [[] for _ in range(P)]  # (slot, obs4)
    for p, kf in enumerate(keyframes):
        T = np.asarray(kf.pose_wc, np.float64)
        for mid, ob in zip(kf.ids, kf.obs):
            d = slot.get(int(mid))
            if d is None:
                continue
            obs_by_pose[p].append((d, np.asarray(ob, np.float64)))
            if not lmk_ok[d]:
                Xc = _triangulate_np(cam, ob)
                if Xc is not None:
                    lmk_w[d] = T[:3, :3] @ Xc + T[:3, 3]
                    lmk_ok[d] = True

    # --- joint information over [P poses | D landmarks] ------------------
    N = n_vars + 3 * D
    Hj = np.zeros((N, N))
    bj = np.zeros(N)
    b2 = kernel_param * kernel_param
    for p in range(P):
        if not obs_by_pose[p]:
            continue
        ds = np.array([d for d, _ in obs_by_pose[p] if lmk_ok[d]], int)
        if ds.size == 0:
            continue
        obs = np.stack([ob for d, ob in obs_by_pose[p] if lmk_ok[d]])
        pix, J_p, J_l = _project_np(cam, poses[p], lmk_w[ds])
        r = obs - pix                                   # [d,4]
        r2 = np.sum(r * r, axis=-1)
        finite = (np.all(np.isfinite(pix), -1)
                  & np.all(np.isfinite(J_p), (1, 2))
                  & np.all(np.isfinite(J_l), (1, 2)))
        rho = 1.0 / np.sqrt(1.0 + r2 / b2)              # pseudo-Huber IRLS
        w = np.where(finite, rho, 0.0)
        w = w * np.array([two_view_weight if pre[dying[d]] == 2 else 1.0
                          for d in ds])
        sp = slice(p * 6, p * 6 + 6)
        # block accumulation (mirrors ba_normal_equations einsums)
        Hj[sp, sp] += np.einsum("d,dij,dik->jk", w, J_p, J_p)
        bj[sp] += np.einsum("d,dij,di->j", w, J_p, r)
        WJl = w[:, None, None] * J_l
        H_pl = np.einsum("dij,dik->djk", J_p, WJl)      # [d,6,3]
        for di, d in enumerate(ds):
            sl = slice(n_vars + 3 * d, n_vars + 3 * d + 3)
            Hj[sp, sl] += H_pl[di]
            Hj[sl, sp] += H_pl[di].T
            Hj[sl, sl] += J_l[di].T @ WJl[di]
            bj[sl] += WJl[di].T @ r[di]

    # --- odometry factor between the evicted pair ------------------------
    w_rot, w_trans = rel_w
    kf0, kf1 = keyframes[0], keyframes[1]
    if ((w_rot > 0 or w_trans > 0)
            and kf0.pose_vo is not None and kf1.pose_vo is not None):
        from scipy.spatial.transform import Rotation

        T_rel = np.linalg.inv(np.asarray(kf1.pose_vo, np.float64)) \
            @ np.asarray(kf0.pose_vo, np.float64)
        rel = np.concatenate([
            Rotation.from_matrix(T_rel[:3, :3]).as_rotvec(), T_rel[:3, 3]])
        e = _relpose_residual_np(poses[0], poses[1], rel)
        J = _relpose_jacobian_np(poses[0], poses[1], rel)   # [6,12]
        Wd = np.concatenate([np.full(3, w_rot), np.full(3, w_trans)])
        JW = J * Wd[:, None]
        Hf = J.T @ JW
        gf = -JW.T @ e
        Hj[:12, :12] += Hf
        bj[:12] += gf

    # --- previous prior (covers keyframes[:prior.n]) ---------------------
    if prior is None or prior.n == 0:
        a_rot, a_trans = anchor_w
        Hj[:6, :6] += np.diag([a_rot] * 3 + [a_trans] * 3)
        # b stays 0: the anchor is centered at the current estimate
    if prior is not None and prior.n > 0:
        n = min(prior.n, P)
        m = n * 6
        dx = (poses[:n] - prior.lin[:n]).reshape(-1)
        Hp = prior.H[:m, :m]
        Hj[:m, :m] += Hp
        # first-order shift of the stored gradient to the new lin point
        bj[:m] += prior.b[:m] - Hp @ dx

    # --- eliminate landmarks + the evicted pose --------------------------
    keep = np.zeros(N, bool)
    keep[6:n_vars] = True
    Hk, bk = schur_marginalize(Hj, bj, keep)
    Hk = _psd_project(Hk)
    return MargPrior(H=Hk, b=bk, lin=poses[1:].copy())
