"""The reference's bundle adjustment over chip_smoke.py's bench scene: the
bounds of its BA phase.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_ba.py [N_FRAMES]

Runs rso (JAX on the CPU) over the first N_FRAMES (30) of the bench scene
(1241x376, 2000 points, speed 0.8, fx 718.856, baseline 0.5371) under
synthetic_config() (with use_mxu_distance=False, the exact dense SAD, as
the port computes it):
  * VOWithBA at its defaults (max_keyframes=8, max_landmarks=1024,
    ba_iters=15): keyframes, BA solves, ATE of the pure VO chain and of the
    BA output;
  * the same with marginalize=True, max_keyframes=4: keyframes, solves,
    evictions, ATE of the BA output;
  * KeyframeCollector (min_kf_gap=3) over a plain engine run, then
    refine_trajectory(window=8, overlap=2) on the 8-device CPU mesh:
    keyframes, windows, ATE of the VO chain and of the refined trajectory.
Poses are camera-to-world after each frame (the first at the origin), held
against the scene's ground truth by rso.metrics.ate.ate_rmse.  Prints one
JSON line (~2-3 minutes, one reference engine for all three runs).
"""
import dataclasses
import json
import os
import sys

import numpy as np

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

from rso.ba.offline import KeyframeCollector, refine_trajectory  # noqa: E402
from rso.ba.pipeline import VOWithBA  # noqa: E402
from rso.ba.window_sharded import split_into_windows  # noqa: E402
from rso.engine import Engine  # noqa: E402
from rso.geometry import StereoCamera, pose_matrix  # noqa: E402
from rso.metrics.ate import ate_rmse  # noqa: E402
from rso.synthetic import make_sequence, synthetic_config  # noqa: E402

H, W = 376, 1241


def bench_scene():
    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=W / 2.0,
                            cy_l=H / 2.0, baseline=0.5371)
    return make_sequence(n_frames=30, n_points=2000, H=H, W=W, cam=cam,
                         speed=0.8)


def config():
    cfg = synthetic_config()
    return cfg.replace(tpu=dataclasses.replace(cfg.tpu, use_mxu_distance=False))


def run_vo_with_ba(vo, engine, frames):
    """(keyframes, solves, VO poses, BA poses) of the pipeline driven by
    `engine` (reset), in place of the one it built."""
    engine.reset()
    vo.engine = engine
    n_kf = n_solve = 0
    vo_poses, ba_poses = [], []
    for left, right in frames:
        out = vo.process_frame(left, right)
        n_kf += out.is_keyframe
        n_solve += out.ba_cost is not None
        vo_poses.append(vo.T.copy())
        ba_poses.append(out.pose_wc)
    return n_kf, n_solve, np.stack(vo_poses), np.stack(ba_poses)


def reference_bounds(n_frames: int = 30) -> dict:
    seq = bench_scene()
    frames, gt = seq.frames[:n_frames], seq.poses[:n_frames]
    cfg = config()
    engine = Engine(cfg, seq.cam)
    out = {"frames": n_frames}

    n_kf, n_solve, vo, ba = run_vo_with_ba(VOWithBA(cfg, seq.cam), engine,
                                           frames)
    out["vo_with_ba"] = dict(keyframes=n_kf, solves=n_solve,
                             ate_vo=float(ate_rmse(vo, gt)),
                             ate_ba=float(ate_rmse(ba, gt)))

    marg = VOWithBA(cfg, seq.cam, marginalize=True, max_keyframes=4)
    n_kf, n_solve, _, ba = run_vo_with_ba(marg, engine, frames)
    out["marginalized"] = dict(keyframes=n_kf, solves=n_solve,
                               evictions=max(n_kf - 4, 0),
                               prior=marg.window.prior is not None,
                               ate_ba=float(ate_rmse(ba, gt)))

    engine.reset()
    collector = KeyframeCollector(engine, cfg)
    T, vo_poses = np.eye(4), []
    for i, (left, right) in enumerate(frames):
        res = engine.process_frame(left, right)
        if bool(res.valid):
            T = T @ np.asarray(pose_matrix(res.pose))
        vo_poses.append(T.copy())
        collector.observe(i, res, T)
    vo_poses = np.stack(vo_poses)
    refined = refine_trajectory(seq.cam, collector.kfs, collector.kf_frame_idx,
                                vo_poses, window=8, overlap=2)
    n = len(collector.kfs)
    out["offline"] = dict(keyframes=n,
                          windows=len(split_into_windows(n, min(8, n),
                                                         min(2, min(8, n) - 1))),
                          ate_vo=float(ate_rmse(vo_poses, gt)),
                          ate_refined=float(ate_rmse(refined, gt)))
    return out


if __name__ == "__main__":
    print(json.dumps(reference_bounds(int(sys.argv[1]) if len(sys.argv) > 1
                                      else 30)))
