#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rso_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. device: CUDA must be available; prints the card's name and power limit;
  2. build: compiles rso_torch/csrc/*.cu with nvcc and loads the library;
  3. kernels: each CUDA kernel against its plain PyTorch twin on the card, at
     the main path's shapes, with the tolerance stated beside each check, and
     the median time of kernel and twin (CUDA events);
  4. engine: 30 frames of the bench scene (1241x376, 2000 points, speed 0.8,
     fx 718.856, baseline 0.5371) through Engine(..., device="cuda"), with
     every kernel's launch counter reset just before and read just after;
     then the first 5 steps again on the CPU (the plain path) from the same
     states, held to the GPU's counts, error codes and poses (the
     tolerances are stated beside the constants below).
The last two lines are a JSON object describing the kernels and the JSON
result line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
H, W = 376, 1241
N_FRAMES = 30
N_CPU_FRAMES = 5
# The CPU plain path against the GPU, one step from the same state each.
# Kernels 1-3 are bit-exact with their twins, so detected and matched
# counts, error codes and validity must be equal.  Kernel 4 is another
# algorithm than its twin (LDL^T vs Cholesky, the reference's own TPU/CPU
# pairing) and the RANSAC gate is 1 px Sampson: a track on the gate may fall
# either way, so the tracked counts may differ by TRACK_SLACK.  With the same
# stage-5 set, poses differ by float32 rounding of the solve's sums only
# (POSE_ATOL_SAME_SET); when one borderline track changed the set (~30
# inliers on the bench scene), the solve moves by ~1 cm of the 0.8 m step
# (POSE_ATOL_OTHER_SET, rotvec rad and translation m).
TRACK_SLACK = 2
POSE_ATOL_SAME_SET = 1e-4
POSE_ATOL_OTHER_SET = 3e-2


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _bench_scene(n_frames: int):
    from rso_torch.geometry import StereoCamera
    from rso_torch.synthetic import make_sequence

    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=W / 2.0,
                            cy_l=H / 2.0, baseline=0.5371)
    return make_sequence(n_frames=n_frames, n_points=2000, H=H, W=W, cam=cam,
                         speed=0.8)


def check_kernels(seq, dev):
    """Phase 3: every kernel against its twin at the main path's shapes."""
    import numpy as np
    import torch

    from rso_torch import kernels as K
    from rso_torch.frontend.detect import detect_features, octave_k_slots
    from rso_torch.frontend.pyramid import build_pyramid, to_grayscale
    from rso_torch.frontend.stereo_match import match_left_right
    from rso_torch.frontend.track import _gather_right
    from rso_torch.synthetic import synthetic_config

    cfg = synthetic_config()
    rng = np.random.default_rng(0)
    report = {}

    # ---- kernel 1: all three octaves of a bench frame ------------------------
    pyr = build_pyramid(to_grayscale(torch.from_numpy(seq.frames[0][0]).to(dev)), 3)
    th = torch.tensor(cfg.detect.initial_FAST_threshold, dtype=torch.int32,
                      device=dev)
    err = 0.0
    for img in pyr:
        out = K.corner_response_cuda(img, th)
        ref = K.corner_response_torch(img, th)
        torch.cuda.synchronize()
        # FAST mask: bit-exact
        if not torch.equal(torch.isneginf(out), torch.isneginf(ref)):
            raise AssertionError(f"corner mask differs at {tuple(img.shape)}")
        fin = torch.isfinite(ref)
        d = (out[fin] - ref[fin]).abs().max().item() if fin.any() else 0.0
        # response: same op order without FMA contraction, so bit-exact is
        # expected; the check allows 1e-6 of the largest response
        tol = 1e-6 * max(1.0, ref[fin].abs().max().item())
        if d > tol:
            raise AssertionError(f"corner response differs by {d} > {tol}")
        print(f"kernel corner_response {tuple(img.shape)}: corners "
              f"{int(fin.sum())}, max|d| {d}", flush=True)
        err = max(err, d)
    ms = _median_ms(lambda: K.corner_response_cuda(pyr[0], th))
    plain = _median_ms(lambda: K.corner_response_torch(pyr[0], th))
    report["corner_response"] = (err, ms, plain)

    # ---- kernels 2, 3: real features of bench frames 0 and 1 per octave -----
    Ks = octave_k_slots(cfg.detect.orb_nfeats, 3, cfg.tpu.max_kps_per_octave)
    frames = []
    for f in (0, 1):
        pl_ = build_pyramid(to_grayscale(torch.from_numpy(seq.frames[f][0]).to(dev)), 3)
        pr_ = build_pyramid(to_grayscale(torch.from_numpy(seq.frames[f][1]).to(dev)), 3)
        octs = []
        for o in range(3):
            fl = detect_features(pl_[o], cfg.detect, Ks[o], th, False)
            fr = detect_features(pr_[o], cfg.detect, Ks[o], th, False)
            m = match_left_right(fl, fr, cfg.lr_match, W >> o, 0.0)
            octs.append((fl, fr, m))
        frames.append(octs)

    def stereo_args(o):
        fl, fr, _ = frames[0][o]
        return (fl.patch, fr.patch, fl.xy, fr.xy, fl.valid, fr.valid)

    stereo_kw = lambda o: dict(max_y_diff=cfg.lr_match.max_y_diff,  # noqa: E731
                               max_disp=(W >> o) * 0.7,
                               max_distance=float(cfg.lr_match.sad_max_distance))

    def track_args(o):
        pl, pr, pm = frames[0][o]
        cl, cr, cm = frames[1][o]
        pR_xy, pR_patch, _ = _gather_right(pr, pm.ridx)
        cR_xy, cR_patch, _ = _gather_right(cr, cm.ridx)
        return (pl.patch, cl.patch, pR_patch, cR_patch, pl.xy, cl.xy,
                pR_xy[:, 0].contiguous(), cR_xy[:, 0].contiguous(),
                pm.valid, cm.valid)

    track_kw = dict(win_row=float(cfg.if_match.ifm_win_w),
                    win_col=float(cfg.if_match.ifm_win_h),
                    sad_max=float(cfg.if_match.sad_max_distance))

    def odd_case(k, seed):
        r = np.random.default_rng(seed)
        # slot j of the second set is a noisy copy of slot perm[j] of the
        # first, 2..40 px to the left and within a pixel in y
        perm = r.permutation(k)
        base = r.integers(0, 255 * 16, (k, 64)) / 16.0
        pert = base[perm] + r.integers(-40, 40, (k, 64)) / 16.0
        xy = r.uniform(10, 300, (k, 2))
        xy2 = xy[perm] - np.stack([r.uniform(-2, 40, k), r.uniform(-1, 1, k)], -1)
        t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
        ok = lambda: t(r.random(k) > 0.1, torch.bool)  # noqa: E731
        return t(base), t(np.clip(pert, 0, 255)), t(xy), t(xy2), ok(), ok()

    def exact(name, a, b, what):
        for x, y in zip(a, b):
            if not torch.equal(x, y):
                raise AssertionError(f"{name} {what}: kernel != twin")
        d = max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))
        print(f"kernel {name} {what}: bit-exact (max|d| {d})", flush=True)
        return d

    err = 0.0
    for o in range(3):
        a = stereo_args(o)
        err = max(err, exact("stereo_sad_fused", K.stereo_sad_fused_cuda(*a, **stereo_kw(o)),
                             K.stereo_sad_fused_torch(*a, **stereo_kw(o)), f"K={Ks[o]}"))
    pl, pr, xl, xr, okl, okr = odd_case(257, 1)
    kw = dict(max_y_diff=1.0, max_disp=100.0, max_distance=6000.0)
    err = max(err, exact("stereo_sad_fused",
                         K.stereo_sad_fused_cuda(pl, pr, xl, xr, okl, okr, **kw),
                         K.stereo_sad_fused_torch(pl, pr, xl, xr, okl, okr, **kw),
                         "K=257"))
    a0 = stereo_args(0)
    ms = _median_ms(lambda: K.stereo_sad_fused_cuda(*a0, **stereo_kw(0)))
    plain = _median_ms(lambda: K.stereo_sad_fused_torch(*a0, **stereo_kw(0)))
    report["stereo_sad_fused"] = (err, ms, plain)

    err = 0.0
    for o in range(3):
        a = track_args(o)
        err = max(err, exact("track_sad_fused", K.track_sad_fused_cuda(*a, **track_kw),
                             K.track_sad_fused_torch(*a, **track_kw), f"K={Ks[o]}"))
    p1, c1, xy1, xy2, okp, okc = odd_case(131, 2)
    p2, c2, _, _, _, _ = odd_case(131, 3)
    a = (p1, c1, p2, c2, xy1, xy2, xy1[:, 0] - 5.0, xy2[:, 0] - 7.0, okp, okc)
    kw = dict(win_row=8.0, win_col=40.0, sad_max=8000.0)
    err = max(err, exact("track_sad_fused", K.track_sad_fused_cuda(*a, **kw),
                         K.track_sad_fused_torch(*a, **kw), "K=131"))
    a0 = track_args(0)
    ms = _median_ms(lambda: K.track_sad_fused_cuda(*a0, **track_kw))
    plain = _median_ms(lambda: K.track_sad_fused_torch(*a0, **track_kw))
    report["track_sad_fused"] = (err, ms, plain)

    # ---- kernel 4: 9x9 null vectors, B = 512 (2 eyes x 256) and B = 1 -------
    err = 0.0
    for B in (512, 1):
        A = torch.tensor(rng.normal(0, 1, (B, 8, 9)), dtype=torch.float32,
                         device=dev)
        M = (A.transpose(1, 2) @ A).contiguous()
        out = K.nullvec9_cuda(M)
        ref = K.nullvec9_torch(M)
        # the twin is another algorithm (regularised Cholesky vs LDL^T):
        # unit norm, same direction up to sign (|cos| > 1 - 1e-3), and a null
        # residual ||M x|| / tr(M) < 1e-3 (tests/test_kernels.py criteria)
        norm = out.norm(dim=1)
        cos = (out * ref).sum(1).abs()
        resid = (M @ out[:, :, None])[..., 0].norm(dim=1) / M.diagonal(
            dim1=1, dim2=2).sum(1)
        if not ((norm - 1).abs().max() < 1e-4 and cos.min() > 1 - 1e-3
                and resid.max() < 1e-3):
            raise AssertionError(f"nullvec9 B={B}: |norm-1| "
                                 f"{(norm - 1).abs().max().item()}, min cos "
                                 f"{cos.min().item()}, resid {resid.max().item()}")
        sign = torch.where((out * ref).sum(1, keepdim=True) < 0, -1.0, 1.0)
        d = (out - sign * ref).abs().max().item()
        print(f"kernel nullvec9 B={B}: min|cos| {cos.min().item()}, max resid "
              f"{resid.max().item()}, max|d| up to sign {d}", flush=True)
        err = max(err, d)
    A = torch.tensor(rng.normal(0, 1, (512, 8, 9)), dtype=torch.float32,
                     device=dev)
    M = (A.transpose(1, 2) @ A).contiguous()
    report["nullvec9"] = (err, _median_ms(lambda: K.nullvec9_cuda(M)),
                          _median_ms(lambda: K.nullvec9_torch(M)))
    return report


def run_engine(seq, dev):
    """Phase 4: the port's main path on the card, counters around it."""
    import numpy as np
    import torch

    from rso_torch.engine import Engine, _tree_map, init_state
    from rso_torch.geometry import pose_matrix
    from rso_torch.kernels import LAUNCHES
    from rso_torch.metrics import ate_rmse
    from rso_torch.synthetic import synthetic_config

    cfg = synthetic_config()
    lefts = [torch.from_numpy(l).to(dev) for l, _ in seq.frames]
    rights = [torch.from_numpy(r).to(dev) for _, r in seq.frames]
    eng = Engine(cfg, seq.cam, device=dev)
    for i in range(3):                          # warm-up (allocator, library)
        eng.process_frame(lefts[i], rights[i])
    eng.reset()
    torch.cuda.synchronize()

    LAUNCHES.clear()
    results, states, step_ms = [], [], []
    t0 = time.perf_counter()
    for i in range(N_FRAMES):
        states.append(eng.state)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        results.append(eng.process_frame(lefts[i], rights[i]))
        b.record()
        step_ms.append((a, b))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)

    for name in ("corner_response", "stereo_sad_fused", "track_sad_fused",
                 "nullvec9"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the engine")
    for r in results:
        for name, t in zip(r._fields, r):
            if t.device.type != "cuda":
                raise AssertionError(f"StepResult.{name} on {t.device}")
    step_ms = sorted(a.elapsed_time(b) for a, b in step_ms[1:])
    med = step_ms[len(step_ms) // 2]

    valid = [bool(r.valid) for r in results]
    T = np.eye(4)
    poses, last = [T.copy()], None
    for r in results[1:]:
        if bool(r.valid):
            last = pose_matrix(r.pose.double().cpu()).numpy()
        if last is not None:             # constant-velocity coast over gaps
            T = T @ last
        poses.append(T.copy())
    ate = ate_rmse(np.stack(poses), seq.poses[:N_FRAMES])
    for r in results:
        if not torch.isfinite(r.pose).all():
            raise AssertionError("non-finite pose")
    print(f"engine: {N_FRAMES} frames, valid {sum(valid)}/{N_FRAMES}, ATE "
          f"{ate} m, median step {med} ms ({1e3 / med} frames/s), wall "
          f"{N_FRAMES / wall} frames/s, launches {launches}", flush=True)
    if sum(valid) < N_FRAMES - 3 or not ate < 1.0:
        raise AssertionError(f"engine output wrong: valid {sum(valid)}, ATE {ate}")

    # the plain path on the CPU, one step from each of the same states
    cpu = Engine(cfg, seq.cam, device="cpu")
    step = cpu._get_step(H, W)
    for i in range(N_CPU_FRAMES):
        st = (init_state(cfg, (H, W)) if states[i] is None
              else _tree_map(lambda t: t.cpu(), states[i]))
        _, rc = step(st, lefts[i].cpu(), rights[i].cpu())
        rg = _tree_map(lambda t: t.cpu(), results[i])
        for name in ("detected_feats", "stereo_matches", "error_code",
                     "valid", "tracked_feats_from_last_frame",
                     "tracked_feats_from_last_KF"):
            c, g = getattr(rc, name), getattr(rg, name)
            slack = TRACK_SLACK if name.startswith("tracked") else 0
            if (c.long() - g.long()).abs().max().item() > slack:
                raise AssertionError(f"frame {i} {name}: cpu {c.tolist()} vs "
                                     f"cuda {g.tolist()}")
        dp = (rc.pose - rg.pose).abs().max().item()
        same_set = torch.equal(rc.track_mask, rg.track_mask)
        print(f"cpu plain path frame {i}: tracked cpu "
              f"{int(rc.tracked_feats_from_last_frame)} cuda "
              f"{int(rg.tracked_feats_from_last_frame)}, same stage-5 set "
              f"{same_set}, GN iterations cpu {int(rc.num_it)}+"
              f"{int(rc.num_it_final)} cuda {int(rg.num_it)}+"
              f"{int(rg.num_it_final)}, max|d pose| {dp}", flush=True)
        if dp > (POSE_ATOL_SAME_SET if same_set else POSE_ATOL_OTHER_SET):
            raise AssertionError(f"frame {i} pose differs by {dp} (same "
                                 f"stage-5 set: {same_set})")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (REPO / "rso_torch" / "csrc").is_dir():
        print(f"chip_smoke: no rso_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    smi = _nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi}", flush=True)

    from rso_torch.kernels import _lib

    t0 = time.perf_counter()
    _lib.load()
    print(f"build: {time.perf_counter() - t0:.1f} s ({_lib.library_path()})",
          flush=True)

    dev = torch.device("cuda")
    seq = _bench_scene(N_FRAMES)
    report = check_kernels(seq, dev)
    launches = run_engine(seq, dev)

    replaces = {
        "corner_response": ("fast_detect.cu", "rso/kernels/fast_detect.py:146"),
        "stereo_sad_fused": ("stereo_fused.cu", "rso/kernels/stereo_fused.py:207"),
        "track_sad_fused": ("stereo_fused.cu", "rso/kernels/stereo_fused.py:133"),
        "nullvec9": ("smallchol.cu", "rso/kernels/smallchol.py:136"),
    }
    kernels = [{"name": n, "route": "cuda", "source": f"rso_torch/csrc/{src}",
                "replaces": rep, "launches": launches[n],
                "max_abs_err": report[n][0], "ms": report[n][1],
                "plain_ms": report[n][2]}
               for n, (src, rep) in replaces.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
