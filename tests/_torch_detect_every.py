"""Where the port parts from rso on the detect_every path, frame by frame.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_detect_every.py \
        [--frames 21] [--no-filter] [--small]

Runs the reference engine (JAX on the CPU) over the first N frames of
chip_smoke.py's phase-8 detect_every scene (the 30-frame bench scene:
1241x376, 2000 points, speed 0.8, fx 718.856, baseline 0.5371;
`synthetic_config()` with detect_every=3 and the exact dense SAD, as
`tests/_torch_paths.py detect_every 21` runs it), then the port on the CPU
over the same frames twice: free-running from the same first state, and one
step at a time from each of the reference's states.  `--small` takes the
160x240 test scene of tests/_torch_paths.py instead; `--no-filter` turns
the RANSAC filter off on both sides.

Per frame it prints the fields of the StepResult and of the next state that
differ beyond tests/_torch_paths.py's tolerances (integers: how many
elements; floats: how many and the largest difference), for the free run
and for the single step.  Where a single step's tracked count differs, it
prints the flat RANSAC filter of that step on the port's inputs: per eye,
each package's winning hypothesis and its inlier count, how many of the
hypotheses reach it, how many hypotheses the two packages count otherwise,
the refit's count; for each hypothesis within one inlier of the top whose
counts differ, the tracks on the other side of the 1 px^2 gate and their
squared Sampson distances in each package; and for every track the two
keep differently, its squared Sampson distance under each package's final
model.  Where a single step's pose differs, it runs rso's pose solve on the
port's solve inputs: how far the port's solve lies from it, and it from
the reference's pose.  Last, the valid counts and ATEs of the three runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import rso_torch.engine as te                                    # noqa: E402
from rso.engine import Engine as JEngine, init_state as j_init_state  # noqa: E402
from rso.geometry import StereoCamera as JCamera, pose_matrix      # noqa: E402
from rso.metrics.ate import ate_rmse                               # noqa: E402
from rso.solver import ransac as JR                                # noqa: E402
from rso.solver.robust_gn import solve_pose as j_solve_pose        # noqa: E402
from rso.synthetic import make_sequence as j_make_sequence        # noqa: E402
from rso.synthetic import synthetic_config as j_synthetic_config  # noqa: E402
from rso_torch import random as rrandom                            # noqa: E402
from rso_torch.geometry import StereoCamera                        # noqa: E402
from rso_torch.solver import ransac as TR                          # noqa: E402
from rso_torch.synthetic import synthetic_config as t_synthetic_config  # noqa: E402
from test_torch_engine import _flat, _tol                          # noqa: E402


def scene(small: bool, n_frames: int):
    if small:
        return j_make_sequence(n_frames=n_frames, n_points=1800, H=160, W=240)
    h, w = 376, 1241
    cam = JCamera.make(fx_l=718.856, fy_l=718.856, cx_l=w / 2.0, cy_l=h / 2.0,
                       baseline=0.5371)
    return j_make_sequence(n_frames=30, n_points=2000, H=h, W=w, cam=cam,
                           speed=0.8)


def configs(ransac: bool):
    """(rso's, rso_torch's) configuration of the path."""
    rep = dataclasses.replace
    out = []
    for cfg in (j_synthetic_config(), t_synthetic_config()):
        cfg = cfg.replace(tpu=rep(cfg.tpu, detect_every=3))
        if not ransac:
            cfg = cfg.replace(if_match=rep(cfg.if_match,
                                           filter_fund_matrix=False))
        out.append(cfg)
    j, t = out
    return j.replace(tpu=rep(j.tpu, use_mxu_distance=False)), t


def diffs(ours, ref) -> list:
    """Fields beyond test_torch_engine's tolerances."""
    a, b = _flat(ours), _flat(ref)
    out = []
    for p in a:
        x, y = a[p], b[p]
        if x.shape != y.shape:
            out.append(f"{p} shape {x.shape} vs {y.shape}")
        elif x.dtype.kind in "biu":
            n = int((x != y.astype(x.dtype)).sum())
            if n:
                out.append(f"{p} {n} differ")
        else:
            atol, rtol = _tol(p)
            bad = ~np.isclose(x, y, atol=atol, rtol=rtol, equal_nan=True)
            if bad.any():
                out.append(f"{p} {int(bad.sum())} beyond tol, max "
                           f"{float(np.nanmax(np.abs(x - y)))!r}")
    return out


def port_scores(p1, p2, mask, key, n_iters, thr):
    """rso_torch's hypothesis counts, winner and refit, as
    ransac_fundamental computes them (float32 on the CPU)."""
    p1n, T1 = TR._normalize_pts(p1, mask)
    p2n, T2 = TR._normalize_pts(p2, mask)
    c = torch.cumsum(mask.to(torch.int32), dim=0)
    n_valid = torch.clamp(c[-1], min=1)
    lanes = torch.arange(8, dtype=torch.int32)
    lo, hi = (lanes * n_valid) // 8, ((lanes + 1) * n_valid) // 8
    width = torch.clamp(hi - lo, min=1).to(torch.float32)
    u = rrandom.uniform(key, (n_iters, 8))
    ranks = torch.minimum(lo + torch.floor(u * width).to(torch.int32),
                          n_valid - 1)
    idx = torch.clamp(torch.searchsorted(c, ranks, right=True),
                      max=p1.shape[0] - 1)
    F = TR._solve_eight_point(p1n[idx], p2n[idx])
    Fs = T2.T @ F @ T1
    d2h = TR._sampson_sq(Fs, p1[None], p2[None])
    scores = (mask & (d2h <= thr * thr)).sum(-1, dtype=torch.int32)
    best = int(torch.argmax(scores))
    Arows = TR._design_rows(p1n, p2n) * (mask & (d2h[best] <= thr * thr))[:, None]
    Fr = T2.T @ TR._null_vector(Arows.T @ Arows) @ T1
    d2r = TR._sampson_sq(Fr, p1, p2)
    score_r = int((mask & (d2r <= thr * thr)).sum())
    d2 = d2r if score_r >= int(scores[best]) else d2h[best]
    return scores.numpy(), best, score_r, d2.numpy(), d2h.numpy()


@jax.jit
def _ref_hyp(p1, p2, mask, key):
    """rso's hypothesis models and their Sampson distances, as its
    ransac_fundamental computes them under jit."""
    N = p1.shape[0]
    p1n, T1 = JR._normalize_pts(p1, mask)
    p2n, T2 = JR._normalize_pts(p2, mask)
    c = jnp.cumsum(mask.astype(jnp.int32))
    n_valid = jnp.maximum(c[-1], 1)
    lanes = jnp.arange(8, dtype=jnp.int32)
    lo, hi = (lanes * n_valid) // 8, ((lanes + 1) * n_valid) // 8
    width = jnp.maximum(hi - lo, 1).astype(jnp.float32)
    u = jax.random.uniform(key, (256, 8))
    ranks = jnp.minimum(lo[None, :] + jnp.floor(u * width[None, :])
                        .astype(jnp.int32), n_valid - 1)
    idx = jnp.minimum(jnp.searchsorted(c, ranks, side="right",
                                       method="compare_all"), N - 1)
    F = JR._solve_eight_point(p1n[idx], p2n[idx])
    Fs = jnp.einsum("ji,hjk,kl->hil", T2, F, T1)
    return jax.vmap(lambda Fp: JR._sampson_sq(Fp, p1, p2))(Fs)


def _jkey(key: torch.Tensor):
    """The port's raw key (two 32-bit words in a wider integer) as jax's."""
    return jnp.asarray(key.numpy().astype(np.uint32))


def ref_scores(p1, p2, mask, key, thr):
    """rso's hypothesis counts, winner and final distances on the same
    inputs (its whole filter for the final model)."""
    args = (jnp.asarray(p1.numpy()), jnp.asarray(p2.numpy()),
            jnp.asarray(mask.numpy()), _jkey(key))
    d2h = np.asarray(_ref_hyp(*args))
    scores = ((d2h <= thr * thr) & np.asarray(mask.numpy())).sum(-1)
    res = jax.jit(JR.ransac_fundamental, static_argnums=(4, 5))(
        *args, 256, thr)
    d2 = np.asarray(JR._sampson_sq(res.F, args[0], args[1]))
    return scores, int(np.argmax(scores)), int(res.n_inliers), d2, d2h


def ransac_report(calls, ref_tmask, n_iters, thr):
    """The recorded filter call of one port step, both packages."""
    (p1s, p2s, mask, keys), out = calls[-1]
    both = out.inliers[0] & out.inliers[1]
    port_tmask = torch.where(out.ok[0] & out.ok[1], both, mask).numpy()
    for eye in range(2):
        ps, pb, pr, pd2, pd2h = port_scores(p1s[eye], p2s[eye], mask,
                                            keys[eye], n_iters, thr)
        rs, rb, rr, rd2, rd2h = ref_scores(p1s[eye], p2s[eye], mask,
                                           keys[eye], thr)
        print(f"    eye {eye}: port best hyp {pb} with {ps[pb]} inliers "
              f"({int((ps == ps[pb]).sum())} hyps at it), refit {pr}; rso best "
              f"hyp {rb} with {rs[rb]} ({int((rs == rs[rb]).sum())} at it), "
              f"final {rr}; {int((ps != rs).sum())} of {len(ps)} hypothesis "
              f"counts differ", flush=True)
        # the hypotheses near the top whose counts differ: the tracks that
        # fall on the other side of the gate, and their distances
        m = mask.numpy()
        top = max(ps.max(), rs.max())
        for hyp in np.flatnonzero(ps != rs):
            if max(ps[hyp], rs[hyp]) < top - 1:
                continue
            flips = np.flatnonzero(((pd2h[hyp] <= thr * thr)
                                    != (rd2h[hyp] <= thr * thr)) & m)
            print(f"      hyp {hyp}: port counts {ps[hyp]}, rso {rs[hyp]}; "
                  f"tracks {flips.tolist()} at d2 {pd2h[hyp][flips].tolist()} "
                  f"(port), {rd2h[hyp][flips].tolist()} (rso)", flush=True)
        for i in np.flatnonzero(port_tmask != ref_tmask):
            print(f"      track {i}: port keeps {bool(port_tmask[i])}, d2 "
                  f"{pd2[i]!r} under the port's model, {rd2[i]!r} under "
                  f"rso's (gate {thr * thr})", flush=True)


def _ate(results, poses):
    T, last, traj = np.eye(4), None, [np.eye(4)]
    for i, res in enumerate(results):
        if i == 0:
            continue
        if bool(res.valid):
            last = np.asarray(pose_matrix(jnp.asarray(np.asarray(res.pose))),
                              np.float64)
        if last is not None:
            T = T @ last
        traj.append(T.copy())
    return float(ate_rmse(np.stack(traj), poses[:len(results)]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=21)
    ap.add_argument("--no-filter", action="store_true")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    n, ransac = args.frames, not args.no_filter
    seq = scene(args.small, n)
    jcfg, tcfg = configs(ransac)
    h, w = seq.frames[0][0].shape
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    eng = JEngine(jcfg, seq.cam)
    rstates, rres = [to_np(j_init_state(jcfg, (h, w)))], []
    for left, right in seq.frames[:n]:
        rres.append(to_np(eng.process_frame(left, right)))
        rstates.append(to_np(eng.state))
    # each step's filter call, recorded (inputs, outputs)
    calls = []
    real = te.ransac_fundamental

    def record(*a, **kw):
        out = real(*a, **kw)
        calls.append((a[:4], out))
        return out

    te.ransac_fundamental = record
    # and each step's pose solve (inputs, output)
    solves = []
    real_solve = te.solve_pose

    def record_solve(*a, **kw):
        out = real_solve(*a, **kw)
        solves.append((a, kw, out))
        return out

    te.solve_pose = record_solve
    cam = StereoCamera.from_numpy(to_np(seq.cam))
    free = te.Engine(tcfg, cam, device="cpu")
    step = te.make_step(tcfg, cam, h, w)
    free_res, step_res = [], []
    print(f"detect_every=3, {n} frames at {h}x{w}, RANSAC filter "
          f"{'on' if ransac else 'off'}", flush=True)
    for i, (left, right) in enumerate(seq.frames[:n]):
        lt, rt = torch.from_numpy(left), torch.from_numpy(right)
        res = free.process_frame(lt, rt)
        d_free = diffs(res, rres[i]) + [
            "state" + d for d in diffs(free.state, rstates[i + 1])]
        calls.clear()
        solves.clear()
        st1, r1 = step(te.state_from_numpy(rstates[i], device="cpu"), lt, rt)
        d_step = diffs(r1, rres[i]) + [
            "state" + d for d in diffs(st1, rstates[i + 1])]
        free_res.append(res)
        step_res.append(r1)
        print(f"frame {i}: since_detect {int(rstates[i + 1].since_detect)}, "
              f"valid rso/free/step {bool(rres[i].valid)}/{bool(res.valid)}/"
              f"{bool(r1.valid)}, tracked "
              f"{int(rres[i].tracked_feats_from_last_frame)}/"
              f"{int(res.tracked_feats_from_last_frame)}/"
              f"{int(r1.tracked_feats_from_last_frame)}", flush=True)
        for what, d in (("free", d_free), ("step", d_step)):
            if d:
                print(f"  {what}: " + "; ".join(d), flush=True)
        if any(d.startswith(".pose") for d in d_step) and solves:
            # the step's pose solve on the port's inputs, by rso's solver
            (_, p_obs, c_obs, smask, _), kw, sol = solves[-1]
            jsol = jax.jit(lambda p, c, m, i, w: j_solve_pose(
                seq.cam, p, c, m, jcfg.least_squares, initial_pose=i,
                obs_weight=w))(*(jnp.asarray(t.numpy()) for t in (
                    p_obs, c_obs, smask, kw["initial_pose"],
                    kw["obs_weight"])))
            print(f"  pose solve on the port's inputs ({int(smask.sum())} "
                  f"observations): port - rso "
                  f"{float(np.abs(sol.pose.numpy() - np.asarray(jsol.pose)).max())!r}, "
                  f"rso's solve - the reference's pose "
                  f"{float(np.abs(np.asarray(jsol.pose) - rres[i].pose).max())!r}",
                  flush=True)
        if ransac and calls and (int(r1.tracked_feats_from_last_frame)
                                 != int(rres[i].tracked_feats_from_last_frame)):
            # the reference's post-filter set: its state's ID claims are not
            # kept, so take it from its filter on the port's inputs
            (p1s, p2s, mask, keys), _ = calls[-1]
            ref_out = [jax.jit(JR.ransac_fundamental, static_argnums=(4, 5))(
                jnp.asarray(p1s[e].numpy()), jnp.asarray(p2s[e].numpy()),
                jnp.asarray(mask.numpy()), _jkey(keys[e]),
                jcfg.tpu.ransac_iters, jcfg.tpu.ransac_threshold)
                for e in range(2)]
            ok = bool(ref_out[0].ok) and bool(ref_out[1].ok)
            ref_tmask = (np.asarray(ref_out[0].inliers)
                         & np.asarray(ref_out[1].inliers)) if ok \
                else mask.numpy()
            print(f"  RANSAC on the port's inputs: rso's filter keeps "
                  f"{int(ref_tmask.sum())}", flush=True)
            ransac_report(calls, ref_tmask, jcfg.tpu.ransac_iters,
                          jcfg.tpu.ransac_threshold)
    te.ransac_fundamental, te.solve_pose = real, real_solve
    for name, results in (("rso", rres), ("port free", free_res),
                          ("port step", step_res)):
        print(f"{name}: {sum(bool(r.valid) for r in results)}/{n} valid, "
              f"ATE {_ate(results, seq.poses)!r} m", flush=True)


if __name__ == "__main__":
    main()
