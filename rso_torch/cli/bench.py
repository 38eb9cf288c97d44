"""rso-bench: per-frame throughput + accuracy benchmark on one device.

Counterpart of rso/cli/bench.py: `run_bench` takes the same arguments plus a
device (the GPU unless the caller passes "cpu"; raises without CUDA) and
returns the same keys.  On the GPU every time is taken on the card: a host
clock to a device synchronize, or CUDA events around the call; on the CPU
the host clock.

  fps                    best of `repeat_passes` passes of process_chunk
                         over every frame;
  fps_live_per_dispatch  60 (at most n_frames) process_frame calls;
  step_ms_device         median of STEP_REPS process_frame calls, alternating
                         two real frames (the reference's slope scan
                         alternates them; the port's step is a Python loop,
                         so each call is timed on its own);
  detect_ms_per_image    median of DETECT_REPS detect_features calls on
                         frame 0; detect_hbm_gbps_model uses the reference's
                         15-pass byte model; detect_hbm_util_vs_v5e_peak is
                         None;
  ate_rmse_m             the first 120 frames with the constant-velocity
                         coast;
  ba_iters_per_sec       the bench's P = 8, L = 1024 problem as a slope
                         between 25 and 75 LM iterations at tol=0 (best of
                         BA_REPS calls each, the two counts in turns); None
                         when the slope is not positive (the reason goes to
                         stderr).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

STEP_REPS = 50
DETECT_REPS = 30
BA_SLOPE_ITERS = (25, 75)
BA_REPS = 3


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _call_ms(dev, fn):
    """(ms, fn()): CUDA events around the call on the GPU, else the host
    clock (eager CPU tensors compute before the call returns)."""
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b), out
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def bench_ba_problem(cam, dev):
    """rso/cli/bench.py:144-152's problem (P = 8, L = 1024, from
    default_rng(0)), its observations from _project_grid, on dev."""
    from rso_torch.ba.ba import BAProblem, _project_grid

    rng = np.random.default_rng(0)
    P, L = 8, 1024
    poses0 = torch.zeros((P, 6), dtype=torch.float32)
    poses0[:, 5] = torch.arange(P, dtype=torch.float32) * -0.4
    lmks0 = torch.from_numpy(np.stack([rng.uniform(-10, 10, L),
                                       rng.uniform(-5, 5, L),
                                       rng.uniform(5, 40, L)], -1)
                             .astype(np.float32))
    poses0, lmks0 = poses0.to(dev), lmks0.to(dev)
    obs = _project_grid(cam.to(dev), poses0, lmks0)[0]
    return BAProblem(poses=poses0 + 0.01, lmks=lmks0 + 0.05, obs=obs,
                     mask=torch.ones((P, L), dtype=torch.bool, device=dev))


def ba_slope(cam, prob, iters=BA_SLOPE_ITERS, reps=BA_REPS,
             solve=None) -> dict:
    """BA iterations/s as the slope of the solve's call time between
    `iters` LM iterations at tol=0, best of `reps` calls each, the two
    counts in turns, after a call of each (the compiled solve captures
    its graphs per max_iters).  solve(cam, prob, max_iters=, tol=) is
    bundle_adjust unless the caller passes another (e.g. the distributed
    solve, bound to its mesh).  `ms_per_iter` and `iters_per_sec` are None
    when the slope is not positive."""
    from rso_torch.ba import bundle_adjust

    solve = solve or bundle_adjust
    dev = prob.poses.device
    lo, hi = iters
    best = {lo: float("inf"), hi: float("inf")}
    for n in (lo, hi):       # warm-up: the first call of each count captures
        solve(cam, prob, max_iters=n, tol=0.0)
    for _ in range(reps):
        for n in (lo, hi):
            ms, out = _call_ms(dev, lambda n=n: solve(
                cam, prob, max_iters=n, tol=0.0))
            if int(out.n_iters) != n:
                raise AssertionError(f"tol=0 ran {int(out.n_iters)} of {n}")
            best[n] = min(best[n], ms)
    dt = best[hi] - best[lo]
    ok = dt > 0
    return {"ms": best, "ms_per_iter": dt / (hi - lo) if ok else None,
            "iters_per_sec": (hi - lo) / dt * 1e3 if ok else None}


def run_bench(n_frames: int = 120, n_points: int = 2000, warmup: int = 3,
              width: int = 1241, height: int = 376, repeat_passes: int = 3,
              device="cuda"):
    from rso_torch.engine import Engine, _device, init_state
    from rso_torch.frontend.detect import detect_features
    from rso_torch.geometry import pose_matrix
    from rso_torch.geometry.stereo_camera import StereoCamera
    from rso_torch.metrics.ate import ate_rmse
    from rso_torch.synthetic import make_sequence, synthetic_config

    dev = _device(device)
    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=width / 2.0,
                            cy_l=height / 2.0, baseline=0.5371)
    seq = make_sequence(n_frames=n_frames, n_points=n_points, H=height,
                        W=width, cam=cam, speed=0.8)
    eng = Engine(synthetic_config(), seq.cam, device=dev)

    # device-resident inputs, stacked for process_chunk
    lefts = torch.from_numpy(np.stack([l for l, _ in seq.frames])).to(dev)
    rights = torch.from_numpy(np.stack([r for _, r in seq.frames])).to(dev)

    # warm-up (allocator, kernel library)
    for i in range(warmup):
        eng.process_frame(lefts[i], rights[i])
    _sync(dev)

    # fps: process_chunk over every frame, best pass
    pass_fps = []
    for _ in range(repeat_passes):
        eng.state = init_state(eng.cfg, (height, width), dev)
        _sync(dev)
        t0 = time.perf_counter()
        results = eng.process_chunk(lefts, rights)
        _sync(dev)
        pass_fps.append(n_frames / (time.perf_counter() - t0))
    fps = max(pass_fps)

    # per-call (live, frame-at-a-time) rate; capped frame count
    n_live = min(n_frames, 60)
    eng.reset()
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(n_live):
        eng.process_frame(lefts[i], rights[i])
    _sync(dev)
    fps_live = n_live / (time.perf_counter() - t0)

    # one step's time, alternating two real frames from the state after
    # frame 0 (a repeated frame would end the pose solve's loop early)
    eng.reset()
    eng.process_frame(lefts[0], rights[0])
    times = []
    for k in range(STEP_REPS):
        i = 1 - k % 2
        ms, _ = _call_ms(dev, lambda i=i: eng.process_frame(lefts[i],
                                                            rights[i]))
        times.append(ms)
    step_ms_device = float(np.median(times))

    # accuracy over a fixed 120-frame window (drift grows with trajectory
    # length), with the constant-velocity coast over invalid frames
    rel_T = pose_matrix(results.pose).cpu().numpy()
    valids = results.valid.cpu().numpy()
    n_ate = min(n_frames, 120)
    T = np.eye(4)
    poses = [T.copy()]
    last_delta = None
    for k in range(n_ate):
        if valids[k]:
            last_delta = rel_T[k]
        if last_delta is not None:
            T = T @ last_delta
        poses.append(T.copy())
    ate = ate_rmse(np.stack(poses)[: n_ate + 1], seq.poses[: n_ate + 1])

    # BA iterations/s, one device
    rate = ba_slope(eng.cam, bench_ba_problem(eng.cam, dev))
    if rate["iters_per_sec"] is None:
        print(f"rso-bench: ba_iters_per_sec is None: the call time did not "
              f"grow from {BA_SLOPE_ITERS[0]} to {BA_SLOPE_ITERS[1]} "
              f"iterations (best ms {rate['ms']})", file=sys.stderr)

    # detection, with the reference's byte model: ~15 f32-plane passes over
    # H*W px (FAST mask 3, Shi-Tomasi ~8, NMS 3, top-K 1)
    img0 = lefts[0].to(torch.float32)
    cfg = eng.cfg
    th = torch.full((), 20, dtype=torch.int32, device=dev)

    def det():
        return detect_features(img0, cfg.detect, cfg.tpu.max_kps_per_octave,
                               th, False, arc=cfg.tpu.fast_arc)

    det()
    detect_ms = float(np.median([_call_ms(dev, det)[0]
                                 for _ in range(DETECT_REPS)]))
    model_passes = 15
    detect_bytes = model_passes * width * height * 4
    detect_gbps = detect_bytes / (detect_ms * 1e-3) / 1e9

    return {
        "fps": fps,
        "fps_live_per_dispatch": fps_live,
        "step_ms_device": step_ms_device,
        "fps_device_step": 1e3 / step_ms_device,
        "ba_iters_per_sec": rate["iters_per_sec"],
        "ate_rmse_m": ate,
        "detect_ms_per_image": detect_ms,
        "detect_hbm_gbps_model": detect_gbps,
        "detect_hbm_util_vs_v5e_peak": None,
        "n_frames": n_frames,
        "image": f"{width}x{height}",
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser("rso-bench", description=__doc__)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--points", type=int, default=2000)
    p.add_argument("--width", type=int, default=1241)
    p.add_argument("--height", type=int, default=376)
    p.add_argument("--passes", type=int, default=3)
    args = p.parse_args(argv)
    out = run_bench(args.frames, args.points, width=args.width,
                    height=args.height, repeat_passes=args.passes,
                    device=device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
