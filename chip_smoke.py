#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rso_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. device: CUDA must be available; prints the card's name and power limit;
  2. build: compiles rso_torch/csrc/*.cu with nvcc and loads the library;
  3. kernels: each of the six CUDA kernels against its plain PyTorch twin on
     the card, at the engine paths' shapes, with the tolerance stated beside
     each check; per kernel, over 50 calls after 5 of warm-up: `ms`, the
     median call time (CUDA events around the Python wrapper, so it includes
     the host's work before the launch is queued: library lookup, operand
     checks, output allocation, the ctypes call); `device_us`, the median of
     the kernel's own duration on the card (torch.profiler's CUDA activity);
     the same call times of the twin and, where one PyTorch call computes the
     same function, of that call (all timed in phase 8); and the kernel's
     bound, the least time the card could take for the same work.  The
     stereo and tracking kernels' bounds count the SAD only on the pairs
     their masks admit (their share is printed, and the all-pairs bound
     beside it); both kernels are also checked and timed with the mask open
     (1e4: every valid pair admitted, for stereo every one with a disparity
     >= 1), and checked on the cases of tests/_torch_stereo_cases.py and
     tests/_torch_track_cases.py; the SAD matrix also at ragged shapes and
     widths; the Hamming matrix's library call is torch.cdist(p=0) on the
     descriptors unpacked to 0/1 floats (checked equal once); two floors
     are timed beside the kernels: `floor_us`, PyTorch's fill of one
     element, and the Hamming matrix's `write_us`, the fill of its [K,K]
     output;
  4. engine, default path: 30 frames of the bench scene (1241x376, 2000
     points, speed 0.8, fx 718.856, baseline 0.5371) through
     Engine(synthetic_config()) on the card, with every kernel's launch
     counter reset just before and read just after; then the first 5 steps
     again on the CPU (the plain path) from the same states, held to the
     GPU's counts, error codes and poses;
  5. engine, descriptor path: FAST_ORB + DESC_RBR + DESC_WIN with oriented
     descriptors (3 octaves, K = 512/256/128), 30 bench frames; the valid
     count and ATE held to bounds set from the reference's own CPU run; 3
     steps again on the CPU;
  6. engine, dense-SAD path: synthetic_config() with use_fused_match=False,
     10 bench frames; 9 sad_matrix launches a frame, no fused ones, and every
     StepResult equal to phase 4's for the same frames;
  7. engine, the remaining modes: ORB + DESC_BF + DESC_BF (one octave) and
     KLT + SAD + SAD, 5 bench frames each, then again on the CPU;
  8. engine, the paths of the preset and the seams, each with its launches
     held to the counts its states imply, its valid count and ATE held to
     bounds from the reference's own CPU run of the same frames
     (`tests/_torch_paths.py`), 3 steps again on the CPU, and the ms a
     frame of its new plain stages (remap, refine, LK levels, LK seed) from
     CUDA events around their calls over 5 more frames:
       kitti         configs/kitti.ini (subpixel refine on), 20 bench frames;
       rectified     configs/euroc.ini through compute_rectify_maps on the
                     distorted rig of make_unrectified_sequence at EuRoC's
                     752x480, 20 frames;
       flow          OPTICAL_FLOW tracking, 20 bench frames (kernel 3 never,
                     kernel 4 on flow's per-octave RANSAC);
       detect_every  detect_every=3, 21 bench frames (kernels 1 and 2 on the
                     detect frames only);
       eigh_lm       the eigh solve with LM damping, 10 bench frames;
     then the seams: precomputed features and matches against the full step
     (3 frames, equal results), a checkpoint round trip on the card,
     reset_ids, and a repeat after a chunk;
  9. bundle adjustment (rso_torch.ba; no kernel of its own: its products
     are cuBLAS GEMMs and one cuSOLVER solve a LM iteration), bounds from
     the reference's own CPU run (`tests/_torch_ba.py`):
       (a) the bench's BA problem (rso/cli/bench.py:144-152: P = 8,
           L = 1024 from default_rng(0)), bundle_adjust(max_iters=15) on
           the card and on the CPU from the same inputs, held together;
           BA iterations/s as the slope of the call time between 25 and 75
           iterations at tol=0 (CUDA events, best of 3, in turns);
       (b) VOWithBA at its defaults (8 keyframes, 1024 landmarks, 15
           iterations) over the 30 bench frames: launches of kernels 1-4
           held to the default path's counts, keyframe and solve counts to
           the reference's within BA_SLACK, finite costs, ATE; ms a frame
           with and without a solve (their difference: the stall per BA
           keyframe), LM iterations per solve; the last solve again on the
           CPU from the card's BAProblem;
       (c) marginalize=True with a 4-keyframe window: evictions, a finite,
           symmetric prior, finite costs;
       (d) KeyframeCollector over a plain run, refine_trajectory(window=8,
           overlap=2): its windows solved as one batch on the card, ATE of
           VO and of the refined trajectory;
 10. the entry points (rso_torch.cli) on the card, each main(argv) with its
     stdout captured and the launch counters reset just before and read
     just after; DEMO_REF from the reference's own CPU run of (a)'s argv
     (`tests/_torch_cli.py`):
       (a) rso-demo --synthetic --frames 30 (--out, --tum, --viz-dir,
           --save-state): 6/3/3/2 launches a frame, valid count and ATE
           within DEMO_REF's bounds, trajectory.html written; then --chunk 8,
           whose KITTI and TUM files equal the per-frame run's; then
           --load-state, whose first frame equals an Engine's given the
           saved state;
       (b) rso-demo --kitti on the 30 bench frames written as a KITTI
           odometry layout (PNG, calib.txt from the bench camera, poses)
           with configs/kitti.ini, 20 frames: the trajectory equals phase
           8's kitti path when the calib round trip gives the bench camera
           (else PATH_REF's bounds);
       (c) --ba and --ba-offline on that layout with SYNTHETIC_INI (phase
           9's configuration), 30 frames: keyframe and solve counts equal
           phase 9b's and 9d's;
       (d) rso-eval on (a)'s trajectory against the ground truth written
           beside it: the ATE the demo printed;
       (e) rso-fleet --synthetic 2 --frames 30 --chunk 8: sequence 0's
           trajectory equals (a)'s; its JSON summary line;
       (f) rso-stages --iters 10 at 1241x376: the span table;
       (g) run_bench at 1241x376, 2000 points, 60 frames, 2 passes: its JSON
           on a line of its own, the reference's keys, finite values;
       (h) rso-demo --live on loopback (the overlay only with cv2): a
           client sees frames on /state, the page's token, /frame.jpg, a
           wrong token refused, and `q` on /control ends the run with 0;
 11. timing: phase 3's call times, then its device times in one profiler
     session, last, since a profiler session slows the process after it;
     each octave-shaped kernel is also timed at the other octaves' shapes
     (`octaves`; the null vectors at the refit's B = 2 beside B = 512), and
     `over_bound_us_per_frame` sums device time less bound over a frame's
     launches (the order of the redesigns).
Each engine phase resets the launch counters just before it and reads them
just after, and holds its first 3 steps equal to its warm-up's (the card is
deterministic).  The last three lines are a JSON object describing the kernels,
the card's name and power limit, and the JSON result line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
H, W = 376, 1241
N_FRAMES = 30
N_CPU_FRAMES = 5
N_DESC_CPU_FRAMES = 3
N_DENSE_FRAMES = 10
N_MODE_FRAMES = 5
# The CPU plain path against the GPU, one step from the same state each.
# Kernels 1-3, 5 and 6 are bit-exact with their twins, on the card and on
# the CPU, so detected and matched counts, error codes and validity must be
# equal.  The flat RANSAC filter is not: kernel 4 is another algorithm than
# its twin (LDL^T vs Cholesky, the reference's own TPU/CPU pairing), and the
# filter's float32 normal equations and scoring sum in another order on the
# card than on the CPU.  That moves a hypothesis's inlier count by a track
# now and then; where hypotheses tie at the top, another one wins, and its
# refit keeps other tracks (tests/_torch_ransac_devices.py).  The tracked
# counts may differ by TRACK_SLACK (measured on these frames: at most 1 on
# the default, descriptor and ORB phases).  KLT_TRACK_SLACK holds for the
# KLT phase only: on its frame 4 the CPU's left-eye hypotheses 5 and 242
# tie at 61 inliers and the first wins; the card counts 60 for hypothesis 5
# and takes 242, whose refit keeps 66 inliers: 55 tracked on the card, 50
# on the CPU (its other frames: equal).  With the filter's arithmetic in
# float64 both devices take 242 and track 54.  With the same stage-5 set,
# poses differ by float32 rounding of the solve's sums only
# (POSE_ATOL_SAME_SET); when the set changed (~30-60 inliers on the bench
# scene), the solve moves by ~1 cm of the 0.8 m step (POSE_ATOL_OTHER_SET,
# rotvec rad and translation m).
TRACK_SLACK = 2
KLT_TRACK_SLACK = 5
POSE_ATOL_SAME_SET = 1e-4
POSE_ATOL_OTHER_SET = 3e-2
# Oriented descriptors: the orientation's moments are exact on both sides,
# but atan2, cos and sin differ in the last ulp between the CPU and CUDA, so
# a sample pair that nearly ties can flip a bit (measured against the
# reference: 3 bits in 2048 descriptors).  A flipped bit may move one stereo
# match: the CPU re-run allows DESC_MATCH_SLACK matches per octave, and the
# descriptors of phase 3 a share DESC_BIT_SHARE of differing bits.
DESC_MATCH_SLACK = 2
DESC_BIT_SHARE = 1e-3
# Phase 5's bounds, from the reference's own CPU run of the same 30 frames
# and configuration (rso.engine.Engine, JAX on the CPU:
# `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_modes.py
# fast_orb_rbr_win 30`): 28 valid frames, ATE 0.0835021 m.  The port may
# lose up to 3 more frames and reach twice the ATE: free-running
# trajectories part through ulp-level differences.
DESC_REF_VALID = 28
DESC_REF_ATE = 0.0835021
# Phase 8: frames per path, and the bounds of each from the reference's own
# CPU run of the same frames and configuration (rso.engine.Engine, JAX on
# the CPU: `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_paths.py
# PATH N_FRAMES`): (valid frames, ATE m).  As for phase 5, the port may lose
# up to 3 more frames and reach twice the ATE.
N_PATH_FRAMES = 20
N_EVERY_FRAMES = 21
N_SOLVE_FRAMES = 10
N_PATH_CPU_FRAMES = 3
N_STAGE_FRAMES = 5
EUROC_H, EUROC_W = 480, 752
PATH_REF = {
    "kitti": (19, 0.02546289078672319),
    "rectified": (19, 0.009820299915523386),
    "flow": (19, 0.029196550111255402),
    "detect_every": (15, 0.5721879200835153),
    "eigh_lm": (9, 0.014722613025692274),
}
# Phase 9, bundle adjustment.  Bounds from the reference's own CPU run of
# the same 30 bench frames (rso.ba, JAX on the CPU: `JAX_PLATFORMS=cpu
# PYTHONPATH=. python tests/_torch_ba.py 30`).  Keyframe and solve counts
# may differ by BA_SLACK: RANSAC near-ties move tracked counts by a track or
# two (ROADMAP Queue 3), and the keyframe policy reads them; ATE at most
# twice the reference's, as for phases 5 and 8.
BA_REF = {
    "vo_with_ba": {"keyframes": 10, "solves": 8, "ate_vo": 0.015853860601408136,
                   "ate_ba": 0.030093093532769156},
    "marginalized": {"keyframes": 10, "solves": 8, "evictions": 6,
                     "ate_ba": 0.051402789999461476},
    "offline": {"keyframes": 10, "windows": 2, "ate_vo": 0.015853860601408136,
                "ate_refined": 0.11402044066615265},
}
BA_SLACK = 2
# A solve on the card against the same solve on the CPU, at the CPU tests'
# bounds (tests/test_torch_ba*.py: poses 5e-5 rad/m, landmarks 3e-3 m, cost
# 2e-5 relative, plus 1e-6 px^2 for costs that reach 0).  n_iters and
# converged are equal, or both runs sat at the f32 noise floor of the cost
# (within BA_FLOOR_RTOL of the converged cost) at the earlier stop: there an
# accept compares costs that differ by less than the two devices' rounding
# of the cost sum (tests/test_torch_ba.py).
BA_POSE_ATOL = 5e-5
BA_LMK_ATOL = 3e-3
BA_COST_RTOL = 2e-5
BA_COST_ATOL = 1e-6
BA_FLOOR_RTOL = 2e-5
# A window of the VOWithBA run is a real problem: its cost is flat along
# some directions (weak parallax, landmarks seen by two keyframes), where
# f32 rounding moves the minimizer without moving the cost.  The card's
# solution must then reach the CPU's cost at the CPU (as above) and lie
# within these of the CPU's: on the run's 8 windows the reference and the
# port on the CPU part by up to 6.1e-4 rad/m and 1.1e-2 m, the card and the
# CPU alike, with costs within 6e-6 (tests/_torch_ba_windows.py on the
# windows the card solved, measured on one H100).
BA_WINDOW_POSE_ATOL = 2e-3
BA_WINDOW_LMK_ATOL = 3e-2
BA_SYM_RTOL = 1e-12
BA_WARM_FRAMES = 10
# Peak rates of the H100 SXM at its 700 W limit (NVIDIA's data sheet): f32
# outside the tensor cores, counted for every scalar operation of the
# kernels (integer ones included), and device memory.
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
# profiler sessions device_times may take before it gives up (one session
# in ten once dropped one launch of 100 on an H100)
PROFILE_ATTEMPTS = 3
# The floors beside the kernels' times: PyTorch's fill kernel, found by its
# functor's symbol (`at::native::FillFunctor<float>`), timed on one element
# (`floor_us`, the least a launch takes) and on kernel 5's [K,K] output
# (`write_us`, the least a kernel that writes that output takes).
FILL_KERNEL = "FillFunctor"
# what the entry-point phase holds against the earlier phases' runs: each
# engine path's StepResults by name (drive), and the BA runs' counts
RUNS = {}


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


def device_times(jobs, reps: int = 50, warmup: int = 5) -> list:
    """Median device duration, in us, of each job's kernel over `reps` calls
    of its function.  jobs: [(kernel, fn)].  Every job runs in ONE
    torch.profiler session (CUDA activity, CUPTI): on an H100, a sixth
    session in one process once recorded no device event at all.  The
    kernels are launched through ctypes, so they are found by their own
    symbol, demangled (`::name(`, `::name<`) or mangled (`<len>nameE`/`I`);
    launches on one stream run in issue order, so the n-th batch of `reps`
    launches of a kernel belongs to the n-th job that names it.  A session
    can also drop an event, which would shift those batches: a session whose
    counts fall short is run again, up to PROFILE_ATTEMPTS times."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _, fn in jobs:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    n_jobs = collections.Counter(k for k, _ in jobs)
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _, fn in jobs:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_kernel, short = {}, []
        for kernel, n in n_jobs.items():
            pat = re.compile(rf"(?:::|\d){kernel}(?:[(<EI]|$)")
            by_kernel[kernel] = sorted(
                (e for e in events if pat.search(e.name)),
                key=lambda e: e.time_range.start)
            if len(by_kernel[kernel]) != n * reps:
                short.append(f"{len(by_kernel[kernel])} launches of {kernel}, "
                             f"expected {n * reps}")
        if not short:
            break
        names = sorted({e.name for e in events})
        print(f"profiler session {attempt + 1} of {PROFILE_ATTEMPTS} saw "
              f"{'; '.join(short)}; device events: {names[:8]}", flush=True)
    else:
        raise AssertionError(f"no profiler session saw every launch: {short}")
    out, taken = [], collections.Counter()
    for kernel, _ in jobs:
        k = taken[kernel]
        taken[kernel] += 1
        t = sorted(e.time_range.elapsed_us()
                   for e in by_kernel[kernel][k * reps:(k + 1) * reps])
        out.append(t[len(t) // 2])
    return out


def _bound(ops: float, n_bytes: float):
    """(bound_ms, bound_by): the larger of operations over the f32 peak and
    bytes (each input read once, each output written once) over the memory
    rate."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bench_scene(n_frames: int):
    from rso_torch.geometry import StereoCamera
    from rso_torch.synthetic import make_sequence

    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=W / 2.0,
                            cy_l=H / 2.0, baseline=0.5371)
    return make_sequence(n_frames=n_frames, n_points=2000, H=H, W=W, cam=cam,
                         speed=0.8)


def rank8_matrices(rng, B: int, dev):
    """[B,9,9] f32 A^T A of 8x9 normal A: PSD of rank 8, as RANSAC's
    8-point normal equations are."""
    import torch

    A = torch.tensor(rng.normal(0, 1, (B, 8, 9)), dtype=torch.float32,
                     device=dev)
    return (A.transpose(1, 2) @ A).contiguous()


def _exact(name, a, b, what):
    """Kernel and twin outputs must be equal bit for bit."""
    import torch

    for x, y in zip(a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{name} {what}: kernel != twin")
    d = max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))
    print(f"kernel {name} {what}: bit-exact (max|d| {d})", flush=True)
    return d


class BenchInputs:
    """The kernels' inputs on the bench scene, as the engine paths give them:
    the 3-octave pyramid of frame 0's left image, and per octave the
    FASTER features (left, right, stereo matches) of frames 0 and 1 and the
    FAST_ORB descriptors of both frames' left images."""

    def __init__(self, seq, dev):
        import torch

        from rso_torch.frontend.detect import detect_features, octave_k_slots
        from rso_torch.frontend.pyramid import build_pyramid, to_grayscale
        from rso_torch.frontend.stereo_match import match_left_right
        from rso_torch.synthetic import mode_config, synthetic_config

        self.cfg = cfg = synthetic_config()
        pyramid = lambda f, eye: build_pyramid(  # noqa: E731
            to_grayscale(torch.from_numpy(seq.frames[f][eye]).to(dev)), 3)
        self.pyr = pyramid(0, 0)
        self.th = torch.tensor(cfg.detect.initial_FAST_threshold,
                               dtype=torch.int32, device=dev)
        self.Ks = octave_k_slots(cfg.detect.orb_nfeats, 3,
                                 cfg.tpu.max_kps_per_octave)
        self.desc_params = mode_config("fast_orb_rbr_win", upright=False).detect
        self.frames, self.descs = [], []
        for f in (0, 1):
            pl_, pr_ = pyramid(f, 0), pyramid(f, 1)
            octs, dsc = [], []
            for o in range(3):
                fl = detect_features(pl_[o], cfg.detect, self.Ks[o], self.th, False)
                fr = detect_features(pr_[o], cfg.detect, self.Ks[o], self.th, False)
                octs.append((fl, fr, match_left_right(fl, fr, cfg.lr_match,
                                                      W >> o, 0.0)))
                dsc.append(detect_features(pl_[o], self.desc_params, self.Ks[o],
                                           self.th, True))
            self.frames.append(octs)
            self.descs.append(dsc)
        self.track_kw = dict(win_row=float(cfg.if_match.ifm_win_w),
                             win_col=float(cfg.if_match.ifm_win_h),
                             sad_max=float(cfg.if_match.sad_max_distance))

    def stereo_args(self, o):
        fl, fr, _ = self.frames[0][o]
        return (fl.patch, fr.patch, fl.xy, fr.xy, fl.valid, fr.valid)

    def stereo_kw(self, o):
        return dict(max_y_diff=self.cfg.lr_match.max_y_diff,
                    max_disp=(W >> o) * 0.7,
                    max_distance=float(self.cfg.lr_match.sad_max_distance))

    def track_args(self, o):
        """Tracking's operands at octave o, frame 0 -> 1 (as track.py
        gathers them)."""
        from rso_torch.frontend.track import _gather_right

        pl, pr, pm = self.frames[0][o]
        cl, cr, cm = self.frames[1][o]
        pR_xy, pR_patch, _ = _gather_right(pr, pm.ridx)
        cR_xy, cR_patch, _ = _gather_right(cr, cm.ridx)
        return (pl.patch, cl.patch, pR_patch, cR_patch, pl.xy, cl.xy,
                pR_xy[:, 0].contiguous(), cR_xy[:, 0].contiguous(),
                pm.valid, cm.valid)


def track_window_pairs(args, kw) -> int:
    """How many (prev, cur) pairs the tracking window and validity admit:
    the twin's mask before its SAD gates, the pairs whose SAD kernel 3
    forms."""
    _, _, _, _, pxy, cxy, prx, crx, okp, okc = args
    d = lambda a, b: (a[:, None] - b[None, :]).abs()  # noqa: E731
    ok = (okp[:, None] & okc[None, :]
          & (d(pxy[:, 1], cxy[:, 1]) <= kw["win_row"])
          & (d(pxy[:, 0], cxy[:, 0]) <= kw["win_col"])
          & (d(prx, crx) <= kw["win_col"]))
    return int(ok.sum())


def stereo_mask_pairs(args, kw) -> int:
    """How many (left, right) pairs the stereo mask and validity admit: the
    twin's mask before its SAD gate, the pairs whose SAD kernel 2 forms."""
    _, _, xyl, xyr, okl, okr = args
    dy = (xyl[:, 1].round()[:, None] - xyr[:, 1].round()[None, :]).abs()
    disp = xyl[:, 0][:, None] - xyr[:, 0][None, :]
    ok = (okl[:, None] & okr[None, :] & (dy <= kw["max_y_diff"])
          & (disp >= 1.0) & (disp <= kw["max_disp"]))
    return int(ok.sum())


def stereo_bound(args, kw):
    """(ops, bytes, admitted pairs) of the stereo function on these inputs:
    the mask on every pair (~10 operations), the SAD only on the admitted
    ones (3 operations a patch value) and its gate and merge (~4); each
    operand read once, three [Kl] outputs written."""
    Kl, P = args[0].shape
    Kr = args[1].shape[0]
    n = stereo_mask_pairs(args, kw)
    return (Kl * Kr * 10 + n * (3 * P + 4),
            4 * (Kl + Kr) * (P + 2) + Kl + Kr + 12 * Kl, n)


def track_bound(args, kw):
    """(ops, bytes, admitted pairs) of the tracking function on these
    inputs: the mask on every pair (~10 operations), the SAD only on the
    admitted ones (6 operations a patch value, both eyes); each operand read
    once, two [Kp] outputs written."""
    Kp, P = args[0].shape
    Kc = args[1].shape[0]
    n = track_window_pairs(args, kw)
    return (Kp * Kc * 10 + n * P * 6, 4 * (Kp + Kc) * (2 * P + 3) + Kp + Kc
            + 8 * Kp, n)


def check_kernels(seq, dev):
    """Phase 3: every kernel against its twin at the engine paths' shapes.
    Returns ({name: dict(max_abs_err, bound_ms, bound_by, ...)}, the calls
    to time), the times being taken by time_kernels after the engines."""
    import numpy as np
    import torch

    from rso_torch import kernels as K
    from rso_torch.frontend.detect import detect_features
    from rso_torch.frontend.pyramid import build_pyramid, to_grayscale
    from rso_torch.kernels.stereo_fused import _best_second

    sys.path.insert(0, str(REPO / "tests"))
    import _torch_stereo_cases as SC
    import _torch_track_cases as TC

    bi = BenchInputs(seq, dev)
    pyr, th, Ks = bi.pyr, bi.th, bi.Ks
    rng = np.random.default_rng(0)
    report = {}

    # (report entry, kernel, kernel call, twin call, library call); each
    # call binds its operands now, since it runs after every check
    timed = []

    def entry(err, fn, kernel, plain, library, ops, n_bytes, shape, note=None):
        """The kernel's report; its times are taken after every check."""
        bound_ms, bound_by = _bound(ops, n_bytes)
        out = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                   shape=shape)
        if note:
            out["library_note"] = note
        timed.append((out, kernel, fn, plain, library))
        return out

    def octave(out, kernel, fn, ops, n_bytes, shape):
        """The kernel at another octave's shape, timed beside its main one:
        `octaves` in its report, for the device time per frame."""
        bound_ms, bound_by = _bound(ops, n_bytes)
        d = dict(shape=shape, bound_ms=bound_ms, bound_by=bound_by)
        out.setdefault("octaves", []).append(d)
        timed.append((d, kernel, fn, None, None))

    # ---- kernel 1: all three octaves of a bench frame ------------------------
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
        # the twin on the CPU, as the CPU re-runs take it: bit-exact
        if not torch.equal(out.cpu(), K.corner_response_torch(img.cpu(), th.cpu())):
            raise AssertionError(f"corner response at {tuple(img.shape)}: "
                                 "kernel != twin on the CPU")
        # the work a thread-per-pixel design divides unevenly: the corners'
        # share of pixels, and of 32-pixel row segments (warps) holding one
        rows = torch.nn.functional.pad(fin, (0, -img.shape[1] % 32))
        warps = rows.view(img.shape[0], -1, 32).any(-1)
        print(f"kernel corner_response {tuple(img.shape)}: corners "
              f"{int(fin.sum())} ({fin.float().mean().item()} of the pixels, "
              f"in {warps.float().mean().item()} of the 32-pixel warps), "
              f"max|d| {d}, equal to the CPU twin", flush=True)
        err = max(err, d)
    n_px = pyr[0].numel()
    # ~190 operations a pixel, counted from the twin's arithmetic: FAST's 32
    # compares and 32 bit packs, ~50 for the two arc tests, 4 for the
    # gradients, 3 products, 48 box-sum adds, 3 means and ~10 for the
    # eigenvalue; one f32 image read, one written
    report["corner_response"] = entry(
        err, lambda img=pyr[0]: K.corner_response_cuda(img, th),
        "corner_response_kernel",
        lambda img=pyr[0]: K.corner_response_torch(img, th), None,
        190 * n_px, 8 * n_px, list(pyr[0].shape),
        "no single PyTorch call computes FAST + Shi-Tomasi")
    for img in pyr[1:]:
        octave(report["corner_response"], "corner_response_kernel",
               lambda img=img: K.corner_response_cuda(img, th),
               190 * img.numel(), 8 * img.numel(), list(img.shape))

    # ---- kernels 2, 3: real features of bench frames 0 and 1 per octave -----
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

    K0, P = Ks[0], 64
    err = 0.0
    for o in range(3):
        a, kw = bi.stereo_args(o), bi.stereo_kw(o)
        open_kw = dict(kw, max_y_diff=1e4, max_disp=1e4)
        for what, k in (("", kw), (" open mask", open_kw)):
            err = max(err, _exact("stereo_sad_fused", K.stereo_sad_fused_cuda(*a, **k),
                                  K.stereo_sad_fused_torch(*a, **k),
                                  f"K={Ks[o]}{what}"))
        n_pairs = Ks[o] * Ks[o]
        print(f"kernel stereo_sad_fused K={Ks[o]}: the mask admits "
              f"{stereo_mask_pairs(a, kw)} of {n_pairs} pairs "
              f"({stereo_mask_pairs(a, kw) / n_pairs}), the open mask "
              f"{stereo_mask_pairs(a, open_kw) / n_pairs}", flush=True)
    pl, pr, xl, xr, okl, okr = odd_case(257, 1)
    kw = dict(max_y_diff=1.0, max_disp=100.0, max_distance=6000.0)
    err = max(err, _exact("stereo_sad_fused",
                          K.stereo_sad_fused_cuda(pl, pr, xl, xr, okl, okr, **kw),
                          K.stereo_sad_fused_torch(pl, pr, xl, xr, okl, okr, **kw),
                          "K=257"))
    for case in SC.CASES:
        args, kw, *_ = SC.stereo_case(case)
        a = tuple(torch.from_numpy(x).to(dev) for x in args)
        err = max(err, _exact("stereo_sad_fused", K.stereo_sad_fused_cuda(*a, **kw),
                              K.stereo_sad_fused_torch(*a, **kw), f"case {case}"))
    a0, kw0 = bi.stereo_args(0), bi.stereo_kw(0)
    ops, n_bytes, n_adm = stereo_bound(a0, kw0)
    report["stereo_sad_fused"] = entry(
        err, lambda a=a0, kw=kw0: K.stereo_sad_fused_cuda(*a, **kw),
        "stereo_sad_kernel",
        lambda a=a0, kw=kw0: K.stereo_sad_fused_torch(*a, **kw),
        None, ops, n_bytes, [K0, K0, P],
        "no single PyTorch call computes the masked best/second")
    # the bound counts the SAD of the admitted pairs only; the all-pairs
    # count (K^2 (3P + 8) operations) is kept beside it for comparison with
    # ratios taken against it
    all_pairs_ms, _ = _bound(K0 * K0 * (3 * P + 8), n_bytes)
    open_kw0 = dict(kw0, max_y_diff=1e4, max_disp=1e4)
    ops_o, _, n_open = stereo_bound(a0, open_kw0)
    open_mask = dict(label="open mask", max_y_diff=1e4, max_disp=1e4,
                     admissible_share=n_open / (K0 * K0),
                     bound_ms=_bound(ops_o, n_bytes)[0])
    report["stereo_sad_fused"].update(
        admissible_share=n_adm / (K0 * K0),
        bound_all_pairs_ms=all_pairs_ms, open_mask=open_mask)
    t = report["stereo_sad_fused"]
    print(f"kernel stereo_sad_fused K={K0}: bound {t['bound_ms']} ms "
          f"({t['bound_by']}), the SAD counted on the {n_adm} admitted pairs "
          f"({n_adm / (K0 * K0)}); the earlier count, the SAD on all pairs: "
          f"{t['bound_all_pairs_ms']} ms; open mask: bound "
          f"{open_mask['bound_ms']} ms, {n_open} pairs admitted", flush=True)
    timed.append((open_mask, "stereo_sad_kernel",
                  lambda a=a0, kw=open_kw0: K.stereo_sad_fused_cuda(*a, **kw),
                  None, None))
    for o in (1, 2):
        a, kw = bi.stereo_args(o), bi.stereo_kw(o)
        ops_o, bytes_o, _ = stereo_bound(a, kw)
        octave(report["stereo_sad_fused"], "stereo_sad_kernel",
               lambda a=a, kw=kw: K.stereo_sad_fused_cuda(*a, **kw),
               ops_o, bytes_o, [Ks[o], Ks[o], P])

    track_kw = bi.track_kw
    dense_kw = dict(track_kw, win_row=1e4, win_col=1e4)
    err = 0.0
    for o in range(3):
        a = bi.track_args(o)
        for what, kw in (("", track_kw), (" open window", dense_kw)):
            err = max(err, _exact("track_sad_fused", K.track_sad_fused_cuda(*a, **kw),
                                  K.track_sad_fused_torch(*a, **kw),
                                  f"K={Ks[o]}{what}"))
        n_pairs = Ks[o] * Ks[o]
        print(f"kernel track_sad_fused K={Ks[o]}: the window admits "
              f"{track_window_pairs(a, track_kw)} of {n_pairs} pairs "
              f"({track_window_pairs(a, track_kw) / n_pairs}), the open window "
              f"{track_window_pairs(a, dense_kw) / n_pairs}", flush=True)
    for case in TC.CASES:
        args, kw, *_ = TC.track_case(case)
        a = tuple(torch.from_numpy(x).to(dev) for x in args)
        err = max(err, _exact("track_sad_fused", K.track_sad_fused_cuda(*a, **kw),
                              K.track_sad_fused_torch(*a, **kw), f"case {case}"))
    p1, c1, xy1, xy2, okp, okc = odd_case(131, 2)
    p2, c2, _, _, _, _ = odd_case(131, 3)
    a = (p1, c1, p2, c2, xy1, xy2, xy1[:, 0] - 5.0, xy2[:, 0] - 7.0, okp, okc)
    kw = dict(win_row=8.0, win_col=40.0, sad_max=8000.0)
    err = max(err, _exact("track_sad_fused", K.track_sad_fused_cuda(*a, **kw),
                          K.track_sad_fused_torch(*a, **kw), "K=131"))
    a0 = bi.track_args(0)
    ops, n_bytes, n_adm = track_bound(a0, track_kw)
    report["track_sad_fused"] = entry(
        err, lambda a=a0: K.track_sad_fused_cuda(*a, **track_kw),
        "track_sad_kernel",
        lambda a=a0: K.track_sad_fused_torch(*a, **track_kw), None, ops, n_bytes,
        [K0, K0, P], "no single PyTorch call computes the windowed argmin")
    # the bound counts the SAD of the admitted pairs only; the all-pairs
    # count (K^2 (6P + 10) operations) is kept beside it for comparison with
    # ratios taken against it
    all_pairs_ms, _ = _bound(K0 * K0 * (6 * P + 10), n_bytes)
    ops_d, _, n_dense = track_bound(a0, dense_kw)
    open_window = dict(label="open window", win=1e4,
                       admissible_share=n_dense / (K0 * K0),
                       bound_ms=_bound(ops_d, n_bytes)[0])
    report["track_sad_fused"].update(
        admissible_share=n_adm / (K0 * K0), bound_all_pairs_ms=all_pairs_ms,
        open_window=open_window)
    t = report["track_sad_fused"]
    print(f"kernel track_sad_fused K={K0}: bound {t['bound_ms']} ms "
          f"({t['bound_by']}), the SAD counted on the {n_adm} admitted pairs "
          f"({n_adm / (K0 * K0)}); the earlier count, the SAD on all pairs: "
          f"{all_pairs_ms} ms; open window: bound {open_window['bound_ms']} "
          f"ms, {n_dense} pairs admitted", flush=True)
    timed.append((open_window, "track_sad_kernel",
                  lambda a=a0: K.track_sad_fused_cuda(*a, **dense_kw), None, None))
    for o in (1, 2):
        a = bi.track_args(o)
        ops_o, bytes_o, _ = track_bound(a, track_kw)
        octave(report["track_sad_fused"], "track_sad_kernel",
               lambda a=a: K.track_sad_fused_cuda(*a, **track_kw), ops_o, bytes_o,
               [Ks[o], Ks[o], P])

    # ---- kernel 4: 9x9 null vectors, B = 512 (2 eyes x 256), 2 (the refit;
    # below 32 a thread reads its own matrix) and 1 --------------------------
    err = 0.0
    Ms = {B: rank8_matrices(rng, B, dev) for B in (512, 2, 1)}
    for B, M in Ms.items():
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
    # ~900 operations a matrix: LDL^T (~490), two inverse iterations
    # (~380), the regularisation; 81 floats in, 9 out.  RANSAC launches it
    # once at B = 512 (2 eyes x 256 hypotheses) and once at B = 2 (the
    # refit of each eye's best): the second shape.  Both are timed on the
    # matrices checked above.
    M = Ms[512]
    report["nullvec9"] = entry(
        err, lambda M=M: K.nullvec9_cuda(M), "nullvec9_kernel",
        lambda M=M: K.nullvec9_torch(M), lambda M=M: torch.linalg.eigh(M),
        512 * 900, 512 * (81 + 9) * 4, [512, 9, 9])
    M = Ms[2]
    octave(report["nullvec9"], "nullvec9_kernel", lambda M=M: K.nullvec9_cuda(M),
           2 * 900, 2 * (81 + 9) * 4, [2, 9, 9])

    # ---- kernel 5: Hamming on FAST_ORB descriptors of frames 0 and 1 --------
    err, n_bits, n_desc = 0.0, 0, 0
    for o in range(3):
        a, b = bi.descs[0][o].desc, bi.descs[1][o].desc
        err = max(err, _exact("hamming_matrix", (K.hamming_matrix_cuda(a, b),),
                              (K.hamming_matrix_torch(a, b),), f"K={Ks[o]}"))
        # the same descriptors on the CPU plain path: oriented bits may flip
        # where a sample pair nearly ties (DESC_BIT_SHARE)
        img = build_pyramid(to_grayscale(torch.from_numpy(seq.frames[0][0])), 3)[o]
        cpu = detect_features(img, bi.desc_params, Ks[o], th.cpu(), True)
        if not torch.equal(cpu.valid, bi.descs[0][o].valid.cpu()):
            raise AssertionError(f"FAST_ORB keypoints differ on the CPU, octave {o}")
        x = torch.bitwise_xor(cpu.desc, a.cpu())[cpu.valid]
        n_bits += int(K.hamming_matrix_torch(x, torch.zeros_like(x[:1])).sum())
        n_desc += int(cpu.valid.sum())
    print(f"descriptors cuda vs cpu: {n_bits} differing bits in {n_desc} "
          f"descriptors", flush=True)
    if n_bits > DESC_BIT_SHARE * 256 * n_desc:
        raise AssertionError(f"descriptor bits differ: {n_bits}")
    r = np.random.default_rng(5)
    words = lambda k: torch.tensor(  # noqa: E731
        r.integers(0, 2**32, (k, 8), dtype=np.uint64).astype(np.uint32)
        .view(np.int32), device=dev)
    wa, wb = words(257), words(131)
    wb[:50] = wa[:50]
    wb[50:100] = wa[:50] ^ torch.tensor(-2**31, dtype=torch.int32, device=dev)
    err = max(err, _exact("hamming_matrix", (K.hamming_matrix_cuda(wa, wb),),
                          (K.hamming_matrix_torch(wa, wb),), "257x131 full range"))
    # 8 tiles a warp with ragged edges: a partial last row block, float4 and
    # scalar stores, a partial last column tile
    for ka, kb in ((600, 600), (512, 501)):
        wa, wb = words(ka), words(kb)
        err = max(err, _exact("hamming_matrix", (K.hamming_matrix_cuda(wa, wb),),
                              (K.hamming_matrix_torch(wa, wb),), f"{ka}x{kb}"))
    # crafted ties: the dense argmin takes the first index, as jnp.argmin
    ta = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    tb = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    tb[:, 0] = torch.tensor([3, 1, 1, 1], dtype=torch.int32, device=dev)
    best, d_best, second = _best_second(K.hamming_matrix_cuda(ta, tb))
    if best.tolist() != [1, 1] or d_best.tolist() != second.tolist():
        raise AssertionError(f"tie rule: best {best.tolist()}")
    # the library call: torch.cdist with p = 0 counts the differing entries
    # of the descriptors unpacked to 256 0/1 floats (unpacked before it is
    # timed); equal to the kernel on these descriptors
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    unpack = lambda d: ((d[:, :, None] >> shifts) & 1).reshape(  # noqa: E731
        d.shape[0], -1).float()
    a, b = bi.descs[0][0].desc, bi.descs[1][0].desc
    bits_a, bits_b = unpack(a), unpack(b)
    if not torch.equal(torch.cdist(bits_a, bits_b, p=0), K.hamming_matrix_cuda(a, b)):
        raise AssertionError("torch.cdist(p=0) of the unpacked bits != kernel 5")
    # the fill of the same [K,K] output: write_us
    fills = {k: torch.empty((k, k), device=dev) for k in Ks}
    report["hamming_matrix"] = entry(
        err, lambda a=a, b=b: K.hamming_matrix_cuda(a, b), "hamming_kernel",
        lambda a=a, b=b: K.hamming_matrix_torch(a, b),
        lambda x=bits_a, y=bits_b: torch.cdist(x, y, p=0),
        K0 * K0 * 8 * 3, (2 * K0 * 8 + K0 * K0) * 4, [K0, K0, 8])
    for o in (1, 2):
        a, b, k = bi.descs[0][o].desc, bi.descs[1][o].desc, Ks[o]
        octave(report["hamming_matrix"], "hamming_kernel",
               lambda a=a, b=b: K.hamming_matrix_cuda(a, b),
               k * k * 8 * 3, (2 * k * 8 + k * k) * 4, [k, k, 8])
    for x, k in zip([report["hamming_matrix"]] + report["hamming_matrix"]["octaves"],
                    Ks):
        x["write"] = dict(label=f"fill {k}x{k}")
        timed.append((x["write"], FILL_KERNEL, fills[k].zero_, None, None))
    report["floor"] = dict(label="fill 1")
    timed.append((report["floor"], FILL_KERNEL, torch.zeros(1, device=dev).zero_,
                  None, None))

    # ---- kernel 6: SAD matrix on bench patches and 1/16-multiples ------------
    err = 0.0
    for o in range(3):
        a, b = bi.frames[0][o][0].patch, bi.frames[1][o][0].patch
        err = max(err, _exact("sad_matrix", (K.sad_matrix_cuda(a, b),),
                              (K.sad_matrix_torch(a, b),), f"K={Ks[o]}"))
    sa, sb = odd_case(257, 6)[0], odd_case(131, 7)[0]
    err = max(err, _exact("sad_matrix", (K.sad_matrix_cuda(sa, sb),),
                          (K.sad_matrix_torch(sa, sb),), "257x131"))
    # ragged tiles, and widths that are not a multiple of 4
    r = np.random.default_rng(8)
    for ka, kb, w in ((1, 1, 64), (1, 257, 64), (257, 1, 64), (131, 257, 64),
                      (131, 257, 63), (131, 257, 65), (40, 33, 128)):
        sa, sb = (torch.tensor(r.integers(0, 255 * 16, (k, w)) / 16.0,
                               dtype=torch.float32, device=dev) for k in (ka, kb))
        err = max(err, _exact("sad_matrix", (K.sad_matrix_cuda(sa, sb),),
                              (K.sad_matrix_torch(sa, sb),), f"{ka}x{kb}, P={w}"))
    a, b = bi.frames[0][0][0].patch, bi.frames[1][0][0].patch
    report["sad_matrix"] = entry(
        err, lambda a=a, b=b: K.sad_matrix_cuda(a, b), "sad_kernel",
        lambda a=a, b=b: K.sad_matrix_torch(a, b),
        lambda a=a, b=b: torch.cdist(a, b, p=1), K0 * K0 * P * 3,
        (2 * K0 * P + K0 * K0) * 4, [K0, K0, P])
    for o in (1, 2):
        a, b, k = bi.frames[0][o][0].patch, bi.frames[1][o][0].patch, Ks[o]
        octave(report["sad_matrix"], "sad_kernel",
               lambda a=a, b=b: K.sad_matrix_cuda(a, b), k * k * P * 3,
               (2 * k * P + k * k) * 4, [k, k, P])

    return report, timed


def time_kernels(timed) -> None:
    """Phase 9: the call times (CUDA events) of every kernel, twin and
    library call, then the kernels' own device times, all in one profiler
    session.  It runs last: after a torch.profiler session the same process
    steps the engine ~25% slower (measured on an H100: 52.1 and 47.7 ms a
    default step before one, 60.9 and 67.0 ms after), and call times, which
    include the host's work, would read high too."""
    for out, _, fn, plain, library in timed:
        out["ms"] = _median_ms(fn)
        if plain is not None:
            out.update(plain_ms=_median_ms(plain),
                       library_ms=_median_ms(library) if library else None)
    us = device_times([(kernel, fn) for _, kernel, fn, _, _ in timed])
    for (out, kernel, *_), u in zip(timed, us):
        out["device_us"] = u
        what = out["label"] if "label" in out else out["shape"]
        print(f"time {kernel} {what}: device {u} us, call {out['ms']} ms, "
              f"bound {out.get('bound_ms')} ms", flush=True)


def _ate(results, gt):
    """ATE of the chained per-frame poses, coasting over invalid frames with
    the last valid motion (the reference's constant-velocity rule)."""
    import numpy as np

    from rso_torch.geometry import pose_matrix
    from rso_torch.metrics import ate_rmse

    T = np.eye(4)
    poses, last = [T.copy()], None
    for r in results[1:]:
        if bool(r.valid):
            last = pose_matrix(r.pose.double().cpu()).numpy()
        if last is not None:
            T = T @ last
        poses.append(T.copy())
    return ate_rmse(np.stack(poses), gt[:len(results)])


def drive(name, cfg, seq, dev, n_frames, maps=None):
    """One engine path on the card: warm-up, then n_frames from a fresh
    state with the launch counters reset just before and read just after.
    `maps`: the rectification maps.  Returns (states, results, launches,
    ATE); the results are also kept in RUNS[name]."""
    import torch

    from rso_torch.engine import Engine
    from rso_torch.kernels import LAUNCHES

    lefts = [torch.from_numpy(l).to(dev) for l, _ in seq.frames[:n_frames]]
    rights = [torch.from_numpy(r).to(dev) for _, r in seq.frames[:n_frames]]
    eng = Engine(cfg, seq.cam, rectify_maps=maps)   # the default device: the card
    if eng.device.type != "cuda":
        raise AssertionError(f"Engine's default device is {eng.device}")
    # warm-up (allocator, library)
    warm = [eng.process_frame(lefts[i], rights[i]) for i in range(3)]
    eng.reset()
    torch.cuda.synchronize()

    LAUNCHES.clear()
    results, states, step_ms = [], [], []
    t0 = time.perf_counter()
    for i in range(n_frames):
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

    # the card is deterministic: the warm-up's steps ran the same frames
    # from the same states
    for i, w in enumerate(warm):
        for field, a, b in zip(w._fields, w, results[i]):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: frame {i} {field} differs "
                                     "between two runs on the card")
    for r in results:
        for field, t in zip(r._fields, r):
            if t.device.type != "cuda":
                raise AssertionError(f"{name}: StepResult.{field} on {t.device}")
        if not torch.isfinite(r.pose).all():
            raise AssertionError(f"{name}: non-finite pose")
    RUNS[name] = results
    times = sorted(a.elapsed_time(b) for a, b in step_ms[1:])
    med = times[len(times) // 2]
    ate = _ate(results, seq.poses)
    n_valid = sum(bool(r.valid) for r in results)
    print(f"engine {name}: {n_frames} frames, valid {n_valid}/{n_frames}, "
          f"ATE {ate} m, median step {med} ms ({1e3 / med} frames/s), wall "
          f"{n_frames / wall} frames/s, launches {launches}", flush=True)
    return states, results, launches, ate


def expect_launches(name, launches, positive=(), zero=(), exact=None):
    for k in positive:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"{name}: kernel {k} was not launched")
    for k in zero:
        if launches.get(k, 0) != 0:
            raise AssertionError(f"{name}: kernel {k} launched {launches[k]}x")
    for k, n in (exact or {}).items():
        if launches.get(k, 0) != n:
            raise AssertionError(f"{name}: kernel {k} launched "
                                 f"{launches.get(k, 0)}x, expected {n}")


def cpu_rerun(name, cfg, seq, states, results, n_frames, match_slack=0,
              track_slack=TRACK_SLACK, maps=None, hw=None):
    """The plain path on the CPU, one step from each of the same states,
    held to the GPU's results (tolerances at the top of the file); `hw`
    defaults to the bench scene's size."""
    import torch

    from rso_torch.engine import _tree_map, init_state, make_step

    hw = hw or (H, W)
    step = make_step(cfg, seq.cam.to(torch.device("cpu")), *hw,
                     rectify_maps=maps)
    for i in range(n_frames):
        st = (init_state(cfg, hw, device="cpu") if states[i] is None
              else _tree_map(lambda t: t.cpu(), states[i]))
        left, right = seq.frames[i]
        _, rc = step(st, torch.from_numpy(left), torch.from_numpy(right))
        rg = _tree_map(lambda t: t.cpu(), results[i])
        for field, slack in (("detected_feats", 0),
                             ("stereo_matches", match_slack),
                             ("error_code", 0), ("valid", 0),
                             ("tracked_feats_from_last_frame", track_slack),
                             ("tracked_feats_from_last_KF", track_slack)):
            c, g = getattr(rc, field), getattr(rg, field)
            if (c.long() - g.long()).abs().max().item() > slack:
                raise AssertionError(f"{name} frame {i} {field}: cpu "
                                     f"{c.tolist()} vs cuda {g.tolist()}")
        dp = (rc.pose - rg.pose).abs().max().item()
        same_set = torch.equal(rc.track_mask, rg.track_mask)
        differ = [f for f, c, g in zip(rc._fields, rc, rg)
                  if not torch.equal(c, g)]
        print(f"cpu plain path {name} frame {i}: tracked cpu "
              f"{int(rc.tracked_feats_from_last_frame)} cuda "
              f"{int(rg.tracked_feats_from_last_frame)}, same stage-5 set "
              f"{same_set}, GN iterations cpu {int(rc.num_it)}+"
              f"{int(rc.num_it_final)} cuda {int(rg.num_it)}+"
              f"{int(rg.num_it_final)}, max|d pose| {dp}, fields that "
              f"differ {differ}", flush=True)
        if dp > (POSE_ATOL_SAME_SET if same_set else POSE_ATOL_OTHER_SET):
            raise AssertionError(f"{name} frame {i} pose differs by {dp} "
                                 f"(same stage-5 set: {same_set})")


def run_engines(seq, dev):
    """Phases 4-7; returns {phase: launches}."""
    import torch

    from rso_torch.synthetic import mode_config, synthetic_config

    out = {}
    fused = ("stereo_sad_fused", "track_sad_fused")

    # ---- phase 4: the default path ------------------------------------------
    cfg = synthetic_config()
    states, results, launches, ate = drive("default", cfg, seq, dev, N_FRAMES)
    expect_launches("default", launches, positive=(
        "corner_response", "nullvec9") + fused,
        zero=("hamming_matrix", "sad_matrix"))
    if sum(bool(r.valid) for r in results) < N_FRAMES - 3 or not ate < 1.0:
        raise AssertionError(f"default path output wrong: ATE {ate}")
    cpu_rerun("default", cfg, seq, states, results, N_CPU_FRAMES)
    out["default"] = launches
    default_results = results

    # ---- phase 5: the descriptor path, oriented -----------------------------
    cfg = mode_config("fast_orb_rbr_win", upright=False)
    states, results, launches, ate = drive("fast_orb_rbr_win", cfg, seq, dev,
                                           N_FRAMES)
    expect_launches("fast_orb_rbr_win", launches, positive=(
        "corner_response", "nullvec9"), zero=fused + ("sad_matrix",),
        exact={"hamming_matrix": 6 * N_FRAMES})   # 3 octaves x (stereo + track)
    n_valid = sum(bool(r.valid) for r in results)
    if n_valid < DESC_REF_VALID - 3 or not ate <= 2 * DESC_REF_ATE:
        raise AssertionError(f"descriptor path: valid {n_valid} (reference "
                             f"{DESC_REF_VALID}), ATE {ate} (reference "
                             f"{DESC_REF_ATE})")
    cpu_rerun("fast_orb_rbr_win", cfg, seq, states, results,
              N_DESC_CPU_FRAMES, match_slack=DESC_MATCH_SLACK)
    out["fast_orb_rbr_win"] = launches

    # ---- phase 6: the dense-SAD path ----------------------------------------
    cfg = mode_config("sad_dense")
    _, results, launches, _ = drive("sad_dense", cfg, seq, dev, N_DENSE_FRAMES)
    expect_launches("sad_dense", launches, positive=("corner_response",),
                    zero=fused + ("hamming_matrix",),
                    exact={"sad_matrix": 9 * N_DENSE_FRAMES})
    for i, (r, f) in enumerate(zip(results, default_results)):
        for field, a, b in zip(r._fields, r, f):
            if a.dtype.is_floating_point:
                same = (a.shape == b.shape
                        and torch.allclose(a, b, rtol=0, atol=1e-6))
            else:
                same = torch.equal(a, b)
            if not same:
                raise AssertionError(f"dense SAD frame {i} {field} differs "
                                     "from the fused path")
    print(f"engine sad_dense: {N_DENSE_FRAMES} StepResults equal the fused "
          "path's", flush=True)
    out["sad_dense"] = launches

    # ---- phase 7: ORB + DESC_BF + DESC_BF, KLT + SAD + SAD -------------------
    cfg = mode_config("orb_bf_bf")
    states, results, launches, _ = drive("orb_bf_bf", cfg, seq, dev,
                                         N_MODE_FRAMES)
    expect_launches("orb_bf_bf", launches, positive=("nullvec9",),
                    zero=fused + ("sad_matrix", "corner_response"),
                    exact={"hamming_matrix": 3 * N_MODE_FRAMES})
    cpu_rerun("orb_bf_bf", cfg, seq, states, results, N_MODE_FRAMES)
    out["orb_bf_bf"] = launches

    cfg = mode_config("klt_sad_sad")
    states, results, launches, _ = drive("klt_sad_sad", cfg, seq, dev,
                                         N_MODE_FRAMES)
    expect_launches("klt_sad_sad", launches, positive=("nullvec9",),
                    zero=("hamming_matrix", "sad_matrix", "corner_response"),
                    exact={k: 3 * N_MODE_FRAMES for k in fused})
    cpu_rerun("klt_sad_sad", cfg, seq, states, results, N_MODE_FRAMES,
              track_slack=KLT_TRACK_SLACK)
    out["klt_sad_sad"] = launches
    return out


class StageTimer:
    """CUDA events around the calls of a few functions of the engine: the
    stream time from just before to just after each call (its kernels, and
    the gaps while the host issues them), summed per stage.  Installed only
    for the timed frames of a phase, after its counted run."""

    def __init__(self, targets):
        self.targets = targets        # [(module, attribute, stage)]
        self.events = collections.defaultdict(list)
        self.saved = []

    def __enter__(self):
        import torch

        for mod, attr, stage in self.targets:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))

            def timed(*a, _fn=fn, _stage=stage, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*a, **kw)
                end.record()
                self.events[_stage].append((start, end))
                return out

            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)

    def ms_per_frame(self, n_frames) -> dict:
        import torch

        torch.cuda.synchronize()
        return {stage: sum(a.elapsed_time(b) for a, b in ev) / n_frames
                for stage, ev in self.events.items()}


def stage_ms(name, cfg, seq, dev, n_frames, maps=None) -> dict:
    """ms a frame of the plain stages new in these paths (remap, refine,
    LK's levels and its coarse seed) and of the whole step, over n_frames
    after a warm-up, with the stage events on."""
    import torch

    import rso_torch.engine as E
    import rso_torch.frontend.optical_flow as OF
    from rso_torch.engine import Engine

    frames = [(torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev))
              for l, r in seq.frames[:n_frames]]
    eng = Engine(cfg, seq.cam, rectify_maps=maps)
    for l, r in frames[:2]:
        eng.process_frame(l, r)
    eng.reset()
    targets = [(E, "bilinear_remap", "remap"), (E, "refine_positions", "refine"),
               (OF, "_lk_level", "lk_level"), (OF, "_coarse_sad_seed", "lk_seed")]
    with StageTimer(targets) as t:
        steps = []
        for l, r in frames:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            eng.process_frame(l, r)
            b.record()
            steps.append((a, b))
        out = t.ms_per_frame(n_frames)
    out["step"] = sum(a.elapsed_time(b) for a, b in steps) / n_frames
    print(f"stages {name}: ms a frame over {n_frames} frames (CUDA events "
          f"around each call) {json.dumps(out)}", flush=True)
    return out


def _launch_counts(cfg, states, results, every=1):
    """The launches a path's run should make, from its states: kernel 1
    twice an octave (both eyes) and kernel 2 once an octave on each frame
    that detects; kernel 3 once an octave on every frame unless the path
    tracks by flow; kernel 4 twice (hypotheses and refit) for each RANSAC
    call: the flat filter once a frame, or flow's per-octave filter."""
    O = cfg.n_octaves
    flow = cfg.if_match.ifm_method == 3
    n = len(results)
    if every == 1:
        detects = n
    else:
        detects = 0
        for st in states:       # the step's own rule, on its own state
            if st is None:      # the first frame's state is made by the step
                detects += 1
                continue
            pairs = sum(int(o.matches.valid.sum()) for o in st.prev.octaves)
            detects += (not bool(st.have_prev) or int(st.since_detect) + 1 >= every
                        or pairs < cfg.tpu.propagate_min_matches
                        or int(st.err_streak) > 0)
    return {"corner_response": 2 * O * detects, "stereo_sad_fused": O * detects,
            "track_sad_fused": 0 if flow else O * n,
            "nullvec9": 2 * (O if flow else 1) * n,
            "hamming_matrix": 0, "sad_matrix": 0}, detects


def _path_phase(name, cfg, seq, dev, n_frames, ref, maps=None, hw=None,
                every=1, match_slack=0):
    """One of the new engine paths: the run with its launches, the bounds
    from the reference's CPU run, the CPU re-run, and its stage times."""
    states, results, launches, ate = drive(name, cfg, seq, dev, n_frames, maps)
    expect, detects = _launch_counts(cfg, states, results, every)
    expect_launches(name, launches, exact=expect)
    n_valid = sum(bool(r.valid) for r in results)
    ref_valid, ref_ate = ref
    print(f"engine {name}: {detects} of {n_frames} frames detected; valid "
          f"{n_valid} (reference {ref_valid}), ATE {ate} (reference "
          f"{ref_ate})", flush=True)
    if n_valid < ref_valid - 3 or not ate <= 2 * ref_ate:
        raise AssertionError(f"{name}: valid {n_valid} (reference "
                             f"{ref_valid}), ATE {ate} (reference {ref_ate})")
    cpu_rerun(name, cfg, seq, states, results, N_PATH_CPU_FRAMES,
              match_slack=match_slack, maps=maps, hw=hw)
    stage_ms(name, cfg, seq, dev, N_STAGE_FRAMES, maps)
    return launches


def run_seams(seq, dev, n_frames=4):
    """The engine's seams on the card: precomputed features and matches
    against the full step that detected them, a checkpoint round trip, a
    repeat after a chunk, and reset_ids.  Returns the launches."""
    import numpy as np
    import torch

    from rso_torch.engine import Engine, init_state
    from rso_torch.frontend.detect import (detect_features, octave_budget,
                                           octave_k_slots)
    from rso_torch.frontend.pyramid import build_pyramid, to_grayscale
    from rso_torch.io import load_state, save_state
    from rso_torch.io.checkpoint import _leaves
    from rso_torch.kernels import LAUNCHES
    from rso_torch.synthetic import synthetic_config

    cfg = synthetic_config()
    O = cfg.n_octaves
    Ks = octave_k_slots(cfg.detect.orb_nfeats, O, cfg.tpu.max_kps_per_octave,
                        cfg.tpu.octave_slot_decay)
    budgets = octave_budget(cfg.detect.orb_nfeats, O)
    frames = [(torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev))
              for l, r in seq.frames[:n_frames]]
    full, feats_eng, match_eng = (Engine(cfg, seq.cam) for _ in range(3))

    def same(a, b, what):
        for field, x, y in zip(a._fields, a, b):
            if not torch.equal(x, y):
                raise AssertionError(f"seams: {what} {field} differs")

    LAUNCHES.clear()
    for i, (l, r) in enumerate(frames[:3]):
        st = full.state if full.state is not None else init_state(cfg, (H, W))
        octs = []
        for o, (pl, pr) in enumerate(zip(build_pyramid(to_grayscale(l), O),
                                         build_pyramid(to_grayscale(r), O))):
            ok = torch.arange(Ks[o], device=dev) < budgets[o]
            fl, fr = (detect_features(p, cfg.detect, Ks[o], st.fast_th[o], False,
                                      arc=cfg.tpu.fast_arc) for p in (pl, pr))
            octs.append((fl._replace(valid=fl.valid & ok),
                         fr._replace(valid=fr.valid & ok)))
        want = full.process_frame(l, r)
        left, right = [a for a, _ in octs], [b for _, b in octs]
        same(feats_eng.process_precomputed(left, right, img_hw=(H, W)), want,
             f"precomputed feats frame {i}")
        m = [(np.flatnonzero(o.matches.valid.cpu().numpy()),
              o.matches.ridx.cpu().numpy()[o.matches.valid.cpu().numpy()])
             for o in full.state.prev.octaves]
        got = match_eng.process_precomputed(left, right, matches=m,
                                            img_hw=(H, W))
        same(got, want, f"precomputed matches frame {i}")
    launches = dict(LAUNCHES)
    print(f"seams: 3 frames of precomputed features and of precomputed "
          f"matches equal to the full step's results, launches {launches}",
          flush=True)
    expect_launches("seams", launches, positive=(
        "corner_response", "stereo_sad_fused", "track_sad_fused", "nullvec9"))

    # checkpoint round trip on the card, then one more step from each
    out_dir = REPO / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = str(out_dir / "state.npz")
    save_state(path, full.state)
    back = Engine(cfg, seq.cam)
    back.state = load_state(path, cfg, (H, W))
    for a, b in zip(_leaves(full.state), _leaves(back.state)):
        if a.device != b.device or not torch.equal(a, b):
            raise AssertionError("checkpoint: a leaf differs after the round trip")
    same(back.process_frame(*frames[3]), full.process_frame(*frames[3]),
         "a step from the loaded checkpoint")

    # reset_ids: current matches renumbered 0..N-1, the frame a keyframe
    full.reset_ids()
    ids = torch.cat([o.match_ids for o in full.state.prev.octaves])
    n = int((ids >= 0).sum())
    if (sorted(ids[ids >= 0].tolist()) != list(range(n))
            or int(full.state.last_kf_max_id) != n - 1
            or int(full.state.last_match_id) != n):
        raise AssertionError("reset_ids did not renumber the matches")

    # a repeat after a chunk re-runs against the state before the chunk
    chunk, plain = Engine(cfg, seq.cam), Engine(cfg, seq.cam)
    chunk.process_frame(*frames[0])
    plain.process_frame(*frames[0])
    chunk.process_chunk([f[0] for f in frames[1:3]], [f[1] for f in frames[1:3]])
    same(chunk.process_frame(*frames[3], repeat=True),
         plain.process_frame(*frames[3]), "repeat after a chunk")
    print(f"seams: checkpoint round trip exact on the card, reset_ids "
          f"renumbered {n} matches, a repeat after a chunk re-ran against "
          "the state before it", flush=True)
    return launches


def run_new_paths(seq, dev):
    """The preset, rectified, flow, detect_every, solve-backend and seam
    phases; returns {phase: launches}."""
    import dataclasses

    from rso_torch.config import load_config
    from rso_torch.io.calib import compute_rectify_maps
    from rso_torch.synthetic import make_unrectified_sequence, synthetic_config

    rep = dataclasses.replace
    out = {}
    # the KITTI preset: subpixel refine, robust 1-to-1, its own thresholds
    cfg = load_config(str(REPO / "configs" / "kitti.ini"))
    out["kitti"] = _path_phase("kitti", cfg, seq, dev, N_PATH_FRAMES,
                               PATH_REF["kitti"])

    # EuRoC's preset on a distorted, misaligned rig at EuRoC's 752x480
    rseq, calib = make_unrectified_sequence(n_frames=N_PATH_FRAMES,
                                            n_points=1800, H=EUROC_H, W=EUROC_W)
    cam, map_l, map_r = compute_rectify_maps(calib)
    rseq = rseq._replace(cam=cam)
    cfg = load_config(str(REPO / "configs" / "euroc.ini"))
    out["rectified"] = _path_phase("rectified", cfg, rseq, dev, N_PATH_FRAMES,
                                   PATH_REF["rectified"], maps=(map_l, map_r),
                                   hw=(EUROC_H, EUROC_W))

    base = synthetic_config()
    cfg = base.replace(if_match=rep(base.if_match, ifm_method=3))
    out["flow"] = _path_phase("flow", cfg, seq, dev, N_PATH_FRAMES,
                              PATH_REF["flow"])

    cfg = base.replace(tpu=rep(base.tpu, detect_every=3))
    out["detect_every"] = _path_phase("detect_every", cfg, seq, dev,
                                      N_EVERY_FRAMES, PATH_REF["detect_every"],
                                      every=3, match_slack=DESC_MATCH_SLACK)

    cfg = base.replace(least_squares=rep(base.least_squares,
                                         solve_backend="eigh", use_lm=True))
    out["eigh_lm"] = _path_phase("eigh_lm", cfg, seq, dev, N_SOLVE_FRAMES,
                                 PATH_REF["eigh_lm"])

    out["seams"] = run_seams(seq, dev)
    return out


def _same_solve(what, card, cpu, rerun_card, rerun_cpu, cost_on_cpu,
                pose_atol=BA_POSE_ATOL, lmk_atol=BA_LMK_ATOL):
    """A BAResult of the card against the CPU's from the same inputs (the
    bounds above): rerun_*(k) solve again with max_iters=k; cost_on_cpu(
    poses, landmarks) is the CPU's cost at a solution, so the card's
    solution must also be the CPU's minimum."""
    dp = (card.poses.cpu() - cpu.poses).abs().max().item()
    dl = (card.lmks.cpu() - cpu.lmks).abs().max().item()
    c_card, c_cpu = float(card.cost), float(cpu.cost)
    c_at = float(cost_on_cpu(card.poses.cpu(), card.lmks.cpu()))
    tol = BA_COST_RTOL * abs(c_cpu) + BA_COST_ATOL
    if (dp > pose_atol or dl > lmk_atol or abs(c_card - c_cpu) > tol
            or abs(c_at - c_cpu) > tol):
        raise AssertionError(f"{what}: card and CPU differ: poses {dp}, "
                             f"landmarks {dl}, cost {c_card} vs {c_cpu} (the "
                             f"card's solution on the CPU: {c_at})")
    its = (int(card.n_iters), int(cpu.n_iters))
    conv = (bool(card.converged), bool(cpu.converged))
    floor = None
    if its[0] != its[1] or conv[0] != conv[1]:
        k = min(its)
        floor = [float(rerun_card(k).cost), float(rerun_cpu(k).cost)]
        limit = BA_FLOOR_RTOL * abs(c_cpu) + BA_COST_ATOL
        if any(abs(c - c_cpu) > limit for c in floor):
            raise AssertionError(f"{what}: n_iters {its}, converged {conv} "
                                 f"part at iteration {k} with costs {floor} "
                                 f"above the floor {c_cpu}")
    print(f"{what}: card vs CPU poses {dp}, landmarks {dl}, cost {c_card} "
          f"vs {c_cpu} (the card's solution on the CPU: {c_at}), n_iters "
          f"{its}, converged {conv}"
          + ("" if floor is None else f" (parted at the noise floor: costs "
             f"{floor} at iteration {min(its)})"), flush=True)


def _bench_ba_problem(cam, dev):
    """rso/cli/bench.py:144-152's problem (P = 8, L = 1024, from
    default_rng(0)), as run_bench builds it."""
    from rso_torch.cli.bench import bench_ba_problem

    return bench_ba_problem(cam, dev)


def _problem_to(prob, dev):
    return type(prob)(*(None if t is None else t.to(dev) for t in prob))


class CallRecorder:
    """Wraps module.attribute to keep each call's arguments and result
    (read after the run, so the timed frames sync no more)."""

    def __init__(self, module, attribute):
        self.module, self.attribute, self.calls = module, attribute, []

    def __enter__(self):
        self.inner = getattr(self.module, self.attribute)

        def wrapped(*args, **kw):
            out = self.inner(*args, **kw)
            self.calls.append((args, kw, out))
            return out

        setattr(self.module, self.attribute, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attribute, self.inner)


def _trajectory_ate(poses, gt):
    import numpy as np

    from rso_torch.metrics import ate_rmse

    return float(ate_rmse(np.stack(poses), gt[:len(poses)]))


def run_ba(seq, dev):
    """Phase 9: bundle adjustment on the card.  Returns the launches of the
    VOWithBA run."""
    import numpy as np
    import torch

    import rso_torch.ba.ba as ba_mod
    import rso_torch.ba.offline as offline
    import rso_torch.ba.pipeline as pipeline
    import rso_torch.ba.window as window_mod
    from rso_torch.ba import (KeyframeCollector, VOWithBA, bundle_adjust,
                              refine_trajectory, split_into_windows)
    from rso_torch.cli.bench import BA_REPS, BA_SLOPE_ITERS, ba_slope
    from rso_torch.engine import Engine
    from rso_torch.geometry import pose_matrix
    from rso_torch.kernels import LAUNCHES
    from rso_torch.synthetic import synthetic_config

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    cam = seq.cam.to(dev)
    ref = BA_REF

    # (a) the bench's BA problem, on the card and on the CPU
    prob = _bench_ba_problem(cam, dev)
    prob_cpu = _problem_to(prob, cpu)
    cam_cpu = seq.cam.to(cpu)
    card = bundle_adjust(cam, prob, max_iters=15)
    if card.poses.device.type != dev.type:
        raise AssertionError(f"bundle_adjust ran on {card.poses.device}")
    host = bundle_adjust(cam_cpu, prob_cpu, max_iters=15)
    _same_solve("ba bench problem P=8 L=1024, 15 iterations", card, host,
                lambda k: bundle_adjust(cam, prob, max_iters=k),
                lambda k: bundle_adjust(cam_cpu, prob_cpu, max_iters=k),
                lambda p, l: bundle_adjust(cam_cpu, prob_cpu._replace(
                    poses=p, lmks=l), max_iters=0).cost)
    rate = ba_slope(cam, prob)
    if rate["iters_per_sec"] is None:
        raise AssertionError(f"BA slope not positive: {rate['ms']}")
    print(f"ba iterations/s (P=8, L=1024, slope {BA_SLOPE_ITERS[0]}-"
          f"{BA_SLOPE_ITERS[1]} iterations at tol=0, best of {BA_REPS}): "
          f"{rate['iters_per_sec']} ({rate['ms_per_iter']} ms an iteration; "
          f"calls {rate['ms']} ms)", flush=True)

    # (b) VOWithBA at its defaults over the bench frames
    cfg = synthetic_config()
    frames = [(torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev))
              for l, r in seq.frames]
    gt = seq.poses
    warm = VOWithBA(cfg, seq.cam)
    if warm.engine.device.type != dev.type:
        raise AssertionError(f"VOWithBA's default device is "
                             f"{warm.engine.device}")
    for left, right in frames[:BA_WARM_FRAMES]:
        warm.process_frame(left, right)
    vo = VOWithBA(cfg, seq.cam)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    LAUNCHES.clear()
    outs, vo_poses, ms = [], [], []
    stages = [(pipeline, "keyframe_obs_from_state", "keyframe_obs"),
              (window_mod.SlidingWindow, "build_problem", "build_problem"),
              (ba_mod, "ba_normal_equations", "normal_equations"),
              (ba_mod, "relpose_prior_terms", "odometry_prior"),
              (ba_mod, "_schur_solve", "schur_solve")]
    with CallRecorder(pipeline, "bundle_adjust") as rec, \
            StageTimer(stages) as st:
        for left, right in frames:
            t0 = time.perf_counter()
            outs.append(vo.process_frame(left, right))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            vo_poses.append(vo.T.copy())
    launches = dict(LAUNCHES)
    expect, _ = _launch_counts(cfg, outs, outs)
    expect_launches("vo_with_ba", launches, exact=expect)
    n_kf = sum(o.is_keyframe for o in outs)
    costs = [o.ba_cost for o in outs if o.ba_cost is not None]
    if not all(np.isfinite(costs)):
        raise AssertionError(f"vo_with_ba: non-finite BA cost in {costs}")
    ate_vo = _trajectory_ate(vo_poses, gt)
    ate_ba = _trajectory_ate([o.pose_wc for o in outs], gt)
    r = ref["vo_with_ba"]
    print(f"vo_with_ba: {len(frames)} frames, {n_kf} keyframes (reference "
          f"{r['keyframes']}), {len(costs)} BA solves (reference "
          f"{r['solves']}), ATE VO {ate_vo} m (reference {r['ate_vo']}), "
          f"ATE BA {ate_ba} m (reference {r['ate_ba']}), launches {launches}",
          flush=True)
    if (abs(n_kf - r["keyframes"]) > BA_SLACK
            or abs(len(costs) - r["solves"]) > BA_SLACK
            or not ate_ba <= 2 * r["ate_ba"]):
        raise AssertionError("vo_with_ba outside the reference's bounds")
    RUNS["vo_with_ba"] = {"keyframes": n_kf, "solves": len(costs),
                          "poses": [o.pose_wc for o in outs]}
    solve = [o.ba_cost is not None for o in outs]
    with_solve = sorted(t for t, s in zip(ms[1:], solve[1:]) if s)
    without = sorted(t for t, s in zip(ms[1:], solve[1:]) if not s)
    med_s, med_n = with_solve[len(with_solve) // 2], without[len(without) // 2]
    iters = [int(out.n_iters) for _, _, out in rec.calls]
    totals = st.ms_per_frame(1)      # summed over the run
    print(f"vo_with_ba ms a frame (host clock to a synchronize, after frame "
          f"0): median {med_n} without a solve ({len(without)} frames), "
          f"{med_s} with one ({len(with_solve)} frames); stall per BA "
          f"keyframe {med_s - med_n} ms; LM iterations per solve {iters}; "
          f"ms by stage over the run's {n_kf} keyframes and {len(costs)} "
          f"solves (CUDA events around each call) {json.dumps(totals)}",
          flush=True)

    # one solve again on the CPU from the card's BAProblem
    (s_cam, s_prob), s_kw, s_out = rec.calls[-1]
    c_prob = _problem_to(s_prob, cpu)
    on_cpu = bundle_adjust(cam_cpu, c_prob, **s_kw)
    _same_solve(f"vo_with_ba last solve (P={s_prob.poses.shape[0]})", s_out,
                on_cpu,
                lambda k: bundle_adjust(s_cam, s_prob, **dict(s_kw, max_iters=k)),
                lambda k: bundle_adjust(cam_cpu, c_prob, **dict(s_kw, max_iters=k)),
                lambda p, l: bundle_adjust(cam_cpu, c_prob._replace(
                    poses=p, lmks=l), **dict(s_kw, max_iters=0)).cost,
                pose_atol=BA_WINDOW_POSE_ATOL, lmk_atol=BA_WINDOW_LMK_ATOL)

    # (c) marginalization: a 4-keyframe window evicts within the frames
    marg = VOWithBA(cfg, seq.cam, marginalize=True, max_keyframes=4)
    m_outs = [marg.process_frame(l, r) for l, r in frames]
    m_kf = sum(o.is_keyframe for o in m_outs)
    m_costs = [o.ba_cost for o in m_outs if o.ba_cost is not None]
    evictions = m_kf - len(marg.window)
    prior = marg.window.prior
    r = ref["marginalized"]
    print(f"marginalized: {m_kf} keyframes (reference {r['keyframes']}), "
          f"{evictions} evictions (reference {r['evictions']}), "
          f"{len(m_costs)} solves (reference {r['solves']}), prior over "
          f"{None if prior is None else prior.n} keyframes, ATE BA "
          f"{_trajectory_ate([o.pose_wc for o in m_outs], gt)} m (reference "
          f"{r['ate_ba']})", flush=True)
    if (prior is None or evictions < 1 or not np.isfinite(prior.H).all()
            or np.abs(prior.H - prior.H.T).max() > BA_SYM_RTOL
            * np.abs(prior.H).max() or not np.isfinite(m_costs).all()):
        raise AssertionError("marginalization: no eviction, or a prior that "
                             "is missing, not finite or not symmetric")

    # (d) offline refinement: keyframes of a plain run, windows in a batch
    eng = Engine(cfg, seq.cam)
    col = KeyframeCollector(eng, cfg)
    T, poses = np.eye(4), []
    for i, (left, right) in enumerate(frames):
        res = eng.process_frame(left, right)
        if bool(res.valid):
            T = T @ pose_matrix(res.pose).cpu().numpy()
        poses.append(T.copy())
        col.observe(i, res, T)
    poses = np.stack(poses)
    with CallRecorder(offline, "window_sharded_bundle_adjust") as solves:
        refined = refine_trajectory(seq.cam, col.kfs, col.kf_frame_idx, poses,
                                    window=8, overlap=2)
    batches = [(len(probs), probs[0].poses.device.type)
               for (_, probs), _, _ in solves.calls]
    n = len(col.kfs)
    n_win = len(split_into_windows(n, min(8, n), min(2, min(8, n) - 1)))
    ate_off, ate_ref = _trajectory_ate(list(poses), gt), _trajectory_ate(
        list(refined), gt)
    r = ref["offline"]
    print(f"offline: {n} keyframes (reference {r['keyframes']}), {n_win} "
          f"windows solved as one batch {batches}, ATE VO {ate_off} m "
          f"(reference {r['ate_vo']}), ATE refined {ate_ref} m (reference "
          f"{r['ate_refined']})", flush=True)
    if (batches != [(n_win, dev.type)] or n_win < 2
            or not ate_ref <= 2 * r["ate_refined"]):
        raise AssertionError("offline refinement: not one batch of >= 2 "
                             "windows on the card, or ATE past its bound")
    RUNS["offline"] = {"keyframes": n, "windows": n_win, "ate_vo": ate_off,
                       "ate_refined": ate_ref}
    print(f"phase 9 (bundle adjustment) took {time.perf_counter() - t_phase} "
          "s", flush=True)
    return launches

# Phase 10, the entry points (rso_torch.cli).  DEMO_REF: the reference's own
# CPU run of (a)'s argv, `rso-demo --synthetic --frames 30` (rso.cli.demo,
# JAX on the CPU: `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_cli.py
# 30`): (valid frames, the ATE it prints, unrounded).  As for phases 5 and
# 8, the port may lose up to 3 more frames and reach twice the ATE.
N_DEMO_FRAMES = 30
DEMO_REF = (29, 0.11118255801335822)
DEMO_CHUNK = 8
N_LIVE_FRAMES = 100
LIVE_SEEN = 12
N_STAGE_ITERS = 10
N_BENCH_FRAMES = 60
N_BENCH_PASSES = 2
# rso/cli/bench.py:219-236
BENCH_KEYS = ["fps", "fps_live_per_dispatch", "step_ms_device",
              "fps_device_step", "ba_iters_per_sec", "ate_rmse_m",
              "detect_ms_per_image", "detect_hbm_gbps_model",
              "detect_hbm_util_vs_v5e_peak", "n_frames", "image", "backend",
              "device"]
# synthetic_config() in the reference's INI keys: the KITTI layout of the
# bench frames runs phase 9's configuration through rso-demo
SYNTHETIC_INI = """[MATCH]
max_y_diff = 1.0
sad_max_distance = 4000
sad_max_ratio = 0.7
enable_robust_1to1_match = true
use_z_gate = true
min_z = 2.0
max_z = 25.0

[IF-MATCH]
sad_max_distance = 4000
"""


def _entry(main, argv, record=False):
    """One entry point's main(argv) on the card with its stdout captured,
    the launch counters reset just before and read just after, and (with
    `record`) every Engine.process_frame result and every bundle_adjust
    call of the BA pipeline kept.  Returns (rc, lines, launches, results,
    ba calls)."""
    import contextlib
    import io

    import torch

    import rso_torch.ba.pipeline as pipeline
    from rso_torch.engine import Engine
    from rso_torch.kernels import LAUNCHES

    buf = io.StringIO()
    torch.cuda.synchronize()
    LAUNCHES.clear()
    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.redirect_stdout(buf))
        rec = ba = None
        if record:
            rec = stack.enter_context(CallRecorder(Engine, "process_frame"))
            ba = stack.enter_context(CallRecorder(pipeline, "bundle_adjust"))
        rc = main(argv)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    results = [out for _, _, out in rec.calls] if record else []
    return rc, buf.getvalue().splitlines(), launches, results, (
        ba.calls if record else [])


def _chained(results):
    """The demo's trajectory from StepResults: the identity, then each
    valid frame's pose matrix composed on (no coast)."""
    import numpy as np

    from rso_torch.geometry import pose_matrix

    T, poses = np.eye(4), [np.eye(4)]
    for r in results:
        if bool(r.valid):
            T = T @ pose_matrix(r.pose).cpu().numpy()
        poses.append(T.copy())
    return np.stack(poses)


def _write_kitti_layout(seq, root: Path):
    """The bench frames as a KITTI odometry sequence: image_0, image_1 (PNG),
    calib.txt from the bench camera and a poses file."""
    import numpy as np
    from PIL import Image

    from rso_torch.io.trajectory import write_kitti

    for eye in (0, 1):
        (root / f"image_{eye}").mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(seq.frames):
        for eye in (0, 1):
            Image.fromarray(frame[eye]).save(root / f"image_{eye}" /
                                             f"{i:06d}.png")
    c = {k: float(v) for k, v in zip(seq.cam._fields, seq.cam)}
    P0 = np.array([[c["fx_l"], 0, c["cx_l"], 0], [0, c["fy_l"], c["cy_l"], 0],
                   [0, 0, 1, 0]])
    P1 = np.array([[c["fx_r"], 0, c["cx_r"], -c["fx_l"] * c["baseline"]],
                   [0, c["fy_r"], c["cy_r"], 0], [0, 0, 1, 0]])
    row = lambda P: " ".join(repr(float(v)) for v in P.ravel())  # noqa: E731
    (root / "calib.txt").write_text(
        f"P0: {row(P0)}\nP1: {row(P1)}\nP2: {row(P0)}\nP3: {row(P1)}\n")
    write_kitti(str(root / "poses.txt"), seq.poses)
    return str(root), str(root / "poses.txt")


def _live(out: Path, have_cv2: bool):
    """(h): rso-demo --live --pause on loopback in a thread.  A client reads
    the page's token, single-steps three frames (`s`), resumes (`p`) until
    /state shows LIVE_SEEN frames, pauses again and sees /state hold, reads
    /frame.jpg, has a wrong token refused, and quits the run (`q`)."""
    import re
    import socket
    import threading
    import urllib.error
    import urllib.request

    from rso_torch.cli import demo

    with socket.socket() as sk:              # a free loopback port
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    argv = ["--synthetic", "--frames", str(N_LIVE_FRAMES), "--pause", "--live",
            str(port), "--out", str(out / "live.txt"), "--verbosity", "0"]
    if not have_cv2:
        argv += ["--live-overlay", "0"]    # the overlay draws with cv2
    box = {}

    def run():
        try:
            box["run"] = _entry(demo.main, argv)
        except Exception as e:               # reported below
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def http(path, data=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=data,
                                     method="GET" if data is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def frame(until, timeout=120.0):
        """/state's newest frame (-1 before the first) once the server
        answers and `until(frame)` holds."""
        t0, f = time.perf_counter(), None
        while time.perf_counter() - t0 < timeout and th.is_alive():
            try:
                f = json.loads(http("/state")[1])["latest"]["frame"]
            except (urllib.error.URLError, ConnectionError, ValueError):
                f = None                     # the server is not up yet
            if f is not None and until(f):
                return f
            time.sleep(0.1)
        raise AssertionError(f"live: /state stopped at frame {f} "
                             f"({box.get('error')!r})")

    frame(lambda f: True)                    # the server answers
    token = re.search(rb"/control\?t=([A-Za-z0-9_-]+)",
                      http("/")[1]).group(1).decode()
    ctl = lambda c: http(f"/control?t={token}", c.encode())  # noqa: E731
    stepped = []
    for i in range(3):
        if ctl("s") != (200, b"ok"):
            raise AssertionError("live: `s` refused")
        stepped.append(frame(lambda f, i=i: f >= i))
    ctl("p")                                 # resume
    seen = frame(lambda f: f >= LIVE_SEEN)
    ctl("p")                                 # pause again
    time.sleep(1.0)
    held = frame(lambda f: True)
    time.sleep(1.0)
    still = frame(lambda f: True)
    jpg = http("/frame.jpg")
    bad = http("/control?t=wrong", b"q")[0]
    quit_ = ctl("q")
    th.join(600)
    if th.is_alive() or "error" in box:
        raise AssertionError(f"live: the run did not end after q "
                             f"({box.get('error')!r})")
    rc, _, launches, _, _ = box["run"]
    n_done = sum(1 for _ in open(out / "live.txt")) - 1
    print(f"entry points (h) rso-demo --live --pause: /state after each `s` "
          f"{stepped}, after `p` {seen}, paused again at {held} then {still}; "
          f"/frame.jpg {jpg[0]} ({len(jpg[1])} bytes); /control with a wrong "
          f"token {bad}, `q` {quit_}; the run ended with code {rc} after "
          f"{n_done} of {N_LIVE_FRAMES} frames, launches {launches}",
          flush=True)
    if (rc != 0 or stepped != [0, 1, 2] or held != still or bad != 403
            or quit_ != (200, b"ok") or n_done != still + 1
            or (have_cv2 and (jpg[0] != 200 or jpg[1][:2] != b"\xff\xd8"))):
        raise AssertionError("live view: a check failed")
    return launches


def run_entry_points(seq, dev, smi: str):
    """Phase 10: the entry points on the card.  Returns the launches of all
    its runs, summed."""
    import importlib.util
    import math

    import numpy as np
    import torch

    from rso_torch.cli import bench, demo, eval as eval_, fleet, stages
    from rso_torch.config import RSOConfig, load_config
    from rso_torch.engine import Engine
    from rso_torch.io import load_kitti_calib, load_state
    from rso_torch.io.trajectory import read_kitti, write_kitti
    from rso_torch.metrics import ate_rmse
    from rso_torch.metrics.logging import error_name
    from rso_torch.synthetic import make_sequence, synthetic_config

    t_phase = time.perf_counter()
    out = REPO / "build" / "chip_smoke" / "cli"
    out.mkdir(parents=True, exist_ok=True)
    total = collections.Counter()
    per_frame = lambda n, O=3: {  # noqa: E731  the default path's launches
        "corner_response": 2 * O * n, "stereo_sad_fused": O * n,
        "track_sad_fused": O * n, "nullvec9": 2 * n, "hamming_matrix": 0,
        "sad_matrix": 0}

    # (a) rso-demo --synthetic, per frame and chunked, then resumed
    a = {k: str(out / f"a.{k}") for k in ("txt", "tum", "npz")}
    argv = ["--synthetic", "--frames", str(N_DEMO_FRAMES), "--out", a["txt"],
            "--tum", a["tum"], "--viz-dir", str(out / "viz"), "--save-state",
            a["npz"], "--verbosity", "0"]
    rc, lines, launches, results, _ = _entry(demo.main, argv, record=True)
    total.update(launches)
    expect_launches("rso-demo", launches, exact=per_frame(N_DEMO_FRAMES))
    dseq = make_sequence(n_frames=N_DEMO_FRAMES, n_points=2000)
    gt_path = str(out / "a_gt.txt")
    write_kitti(gt_path, dseq.poses)
    est = read_kitti(a["txt"])
    n_valid = sum(bool(r.valid) for r in results)
    ate = ate_rmse(est[:N_DEMO_FRAMES], dseq.poses)
    fps_line = next(x for x in lines if "FPS" in x)
    a_ate = next(x for x in lines if x.startswith("[rso] ATE RMSE"))
    print(f"entry points (a) rso-demo --synthetic --frames {N_DEMO_FRAMES}: "
          f"rc {rc}, valid {n_valid} (reference {DEMO_REF[0]}), ATE {ate} m "
          f"(reference {DEMO_REF[1]}); '{fps_line}' '{a_ate}' on {smi}; "
          f"launches {launches}", flush=True)
    if (rc != 0 or n_valid < DEMO_REF[0] - 3 or not ate <= 2 * DEMO_REF[1]
            or len(results) != N_DEMO_FRAMES
            or not (out / "viz" / "trajectory.html").is_file()):
        raise AssertionError("rso-demo: outside the reference's bounds, or "
                             "no trajectory.html")
    c = {k: str(out / f"chunk.{k}") for k in ("txt", "tum")}
    rc, lines, launches, _, _ = _entry(demo.main, argv[:3] + [
        "--chunk", str(DEMO_CHUNK), "--out", c["txt"], "--tum", c["tum"],
        "--verbosity", "0"])
    total.update(launches)
    expect_launches("rso-demo --chunk", launches, exact=per_frame(N_DEMO_FRAMES))
    same = all(Path(a[k]).read_bytes() == Path(c[k]).read_bytes()
               for k in ("txt", "tum"))
    print(f"entry points (a) rso-demo --chunk {DEMO_CHUNK}: rc {rc}, "
          f"trajectory (KITTI and TUM files) equal to the per-frame run's: "
          f"{same}; '{next(x for x in lines if 'FPS' in x)}' on {smi}",
          flush=True)
    if rc != 0 or not same:
        raise AssertionError("rso-demo --chunk: not the per-frame trajectory")
    rc, lines, launches, resumed, _ = _entry(demo.main, argv[:3] + [
        "--load-state", a["npz"], "--out", str(out / "resumed.txt"),
        "--verbosity", "1"], record=True)
    total.update(launches)
    direct = Engine(synthetic_config(), dseq.cam)
    direct.state = load_state(a["npz"], synthetic_config())
    first = direct.process_frame(*dseq.frames[0])
    same = all(torch.equal(x, y) for x, y in zip(first, resumed[0]))
    print(f"entry points (a) rso-demo --load-state: rc {rc}, first frame "
          f"'{lines[0]}', equal to an Engine given the saved state: {same}",
          flush=True)
    if rc != 0 or not same or int(first.error_code) == 5 or \
            error_name(first.error_code) not in lines[0]:
        raise AssertionError("rso-demo --load-state did not resume")

    # (b) rso-demo --kitti on the bench frames at full width
    kdir, kposes = _write_kitti_layout(seq, out / "kitti")
    kcam = load_kitti_calib(str(Path(kdir) / "calib.txt"))
    same_cam = all(torch.equal(x, y) for x, y in zip(kcam, seq.cam))
    kitti_ini = str(REPO / "configs" / "kitti.ini")
    same_cfg = load_config(kitti_ini, base=RSOConfig()) == load_config(kitti_ini)
    rc, lines, launches, results, _ = _entry(demo.main, [
        "--kitti", kdir, "--poses", kposes, "--config", kitti_ini,
        "--frames", str(N_PATH_FRAMES), "--out", str(out / "b.txt"),
        "--verbosity", "0"], record=True)
    total.update(launches)
    expect_launches("rso-demo --kitti", launches,
                    exact=per_frame(N_PATH_FRAMES))
    write_kitti(str(out / "b_phase8.txt"), _chained(RUNS["kitti"]))
    equal = (out / "b.txt").read_bytes() == (out / "b_phase8.txt").read_bytes()
    n_valid = sum(bool(r.valid) for r in results)
    ate_b = _ate(results, seq.poses)
    print(f"entry points (b) rso-demo --kitti at {W}x{H}: rc {rc}, calib "
          f"round trip gives the bench camera: {same_cam}, the demo's config "
          f"is phase 8's: {same_cfg}, trajectory equal to phase 8's kitti "
          f"path: {equal}; valid {n_valid}, ATE {ate_b} m (reference "
          f"{PATH_REF['kitti']}); "
          f"'{next(x for x in lines if 'FPS' in x)}' on {smi}", flush=True)
    if rc != 0 or not same_cfg:
        raise AssertionError("rso-demo --kitti failed")
    if same_cam and not equal:
        raise AssertionError("rso-demo --kitti: not phase 8's trajectory")
    if not same_cam and (n_valid < PATH_REF["kitti"][0] - 3
                         or not ate_b <= 2 * PATH_REF["kitti"][1]):
        raise AssertionError("rso-demo --kitti outside PATH_REF's bounds")

    # (c) --ba and --ba-offline on the same layout with phase 9's config
    ini = out / "synthetic.ini"
    ini.write_text(SYNTHETIC_INI)
    if load_config(str(ini)) != synthetic_config():
        raise AssertionError("SYNTHETIC_INI is not synthetic_config()")
    base = ["--kitti", kdir, "--poses", kposes, "--config", str(ini),
            "--frames", str(N_FRAMES), "--verbosity", "0"]
    rc, lines, launches, _, solves = _entry(
        demo.main, base + ["--ba", "--out", str(out / "c_ba.txt")], record=True)
    total.update(launches)
    expect_launches("rso-demo --ba", launches, exact=per_frame(N_FRAMES))
    n_kf = int(next(x for x in lines if "keyframes in window BA" in x)
               .split()[1])
    ref = RUNS["vo_with_ba"]
    write_kitti(str(out / "c_phase9.txt"),
                np.stack([np.eye(4)] + ref["poses"]))
    dp = np.abs(read_kitti(str(out / "c_ba.txt"))
                - read_kitti(str(out / "c_phase9.txt"))).max()
    print(f"entry points (c) rso-demo --ba over {N_FRAMES} bench frames: rc "
          f"{rc}, {n_kf} keyframes and {len(solves)} BA solves (phase 9b: "
          f"{ref['keyframes']} and {ref['solves']}), trajectory within {dp} m"
          f" of 9b's; '{next(x for x in lines if 'FPS' in x)}' on {smi}",
          flush=True)
    if rc != 0 or (n_kf, len(solves)) != (ref["keyframes"], ref["solves"]):
        raise AssertionError("rso-demo --ba: not phase 9b's counts")
    rc, lines, launches, _, _ = _entry(
        demo.main, base + ["--ba-offline", "--out", str(out / "c_off.txt")])
    total.update(launches)
    expect_launches("rso-demo --ba-offline", launches,
                    exact=per_frame(N_FRAMES))
    n_kf = int(next(x for x in lines if "offline window-sharded refine" in x)
               .split()[-2])
    ate_line = next(x for x in lines if "VO-only ATE" in x)
    ref = RUNS["offline"]
    print(f"entry points (c) rso-demo --ba-offline: rc {rc}, {n_kf} "
          f"keyframes (phase 9d: {ref['keyframes']}), '{ate_line}' (phase 9d: "
          f"VO {ref['ate_vo']:.4f} m, refined {ref['ate_refined']:.4f} m)",
          flush=True)
    if rc != 0 or n_kf != ref["keyframes"]:
        raise AssertionError("rso-demo --ba-offline: not phase 9d's count")

    # (d) rso-eval on (a)'s trajectory against the ground truth beside it
    rc, lines, _, _, _ = _entry(eval_.main, [a["txt"], gt_path])
    print(f"entry points (d) rso-eval: rc {rc}, {lines}; the demo printed "
          f"'{a_ate}'", flush=True)
    if rc != 0 or not a_ate.startswith(f"[rso] {lines[0]} |"):
        raise AssertionError("rso-eval: not the demo's ATE")

    # (e) rso-fleet: two sequences, chunked; sequence 0 is (a)'s
    fdir = out / "fleet"
    rc, lines, launches, _, _ = _entry(fleet.main, [
        "--synthetic", "2", "--frames", str(N_DEMO_FRAMES), "--chunk",
        str(DEMO_CHUNK), "--out-dir", str(fdir)])
    total.update(launches)
    expect_launches("rso-fleet", launches,
                    exact=per_frame(2 * N_DEMO_FRAMES))
    summary = json.loads(lines[-1])
    same = (fdir / "seq_synthetic_0.txt").read_bytes() == \
        Path(a["txt"]).read_bytes()
    print(f"entry points (e) rso-fleet on {smi}: {lines[-1]}", flush=True)
    print(f"entry points (e) sequence 0 equal to (a)'s trajectory: {same}",
          flush=True)
    if rc != 0 or not same or summary["mesh_devices"] != 1:
        raise AssertionError("rso-fleet: sequence 0 is not the demo's run")

    # (f) rso-stages at the bench size
    rc, lines, _, _, _ = _entry(stages.main, [
        "--width", str(W), "--height", str(H), "--iters", str(N_STAGE_ITERS)])
    print(f"entry points (f) rso-stages --iters {N_STAGE_ITERS} at {W}x{H} "
          f"on {smi}:", flush=True)
    for x in lines:
        print(f"  {x}", flush=True)
    if rc != 0 or not any(x.startswith("_stg5 (robust GN)") for x in lines):
        raise AssertionError("rso-stages: no span table")

    # (g) run_bench at the bench size
    res = bench.run_bench(n_frames=N_BENCH_FRAMES, n_points=2000, width=W,
                          height=H, repeat_passes=N_BENCH_PASSES)
    print(f"entry points (g) run_bench({N_BENCH_FRAMES} frames, {W}x{H}, "
          f"{N_BENCH_PASSES} passes) on {smi}: {json.dumps(res)}", flush=True)
    bad = [k for k, v in res.items() if isinstance(v, float)
           and not (math.isfinite(v) and v > 0)]
    if (list(res) != BENCH_KEYS or bad
            or res["detect_hbm_util_vs_v5e_peak"] is not None
            or res["backend"] != "cuda"):
        raise AssertionError(f"run_bench: keys {list(res)}, values not finite "
                             f"and positive: {bad}")

    # (h) --live on loopback
    have_cv2 = importlib.util.find_spec("cv2") is not None
    total.update(_live(out, have_cv2))
    print(f"phase 10 (entry points) took {time.perf_counter() - t_phase} s",
          flush=True)
    return dict(total)


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
    report, timed = check_kernels(seq, dev)
    by_phase = run_engines(seq, dev)
    by_phase.update(run_new_paths(seq, dev))
    by_phase["vo_with_ba"] = run_ba(seq, dev)
    by_phase["entry_points"] = run_entry_points(seq, dev, smi)
    time_kernels(timed)

    # the phase whose path each kernel's launches are read from
    kernels = {
        "corner_response": ("fast_detect.cu", "rso/kernels/fast_detect.py:146", "default"),
        "stereo_sad_fused": ("stereo_fused.cu", "rso/kernels/stereo_fused.py:207", "default"),
        "track_sad_fused": ("stereo_fused.cu", "rso/kernels/stereo_fused.py:133", "default"),
        "nullvec9": ("smallchol.cu", "rso/kernels/smallchol.py:136", "default"),
        "hamming_matrix": ("distance.cu", "rso/kernels/distance.py:157", "fast_orb_rbr_win"),
        "sad_matrix": ("distance.cu", "rso/kernels/distance.py:123", "sad_dense"),
    }
    frames = {"default": N_FRAMES, "fast_orb_rbr_win": N_FRAMES,
              "sad_dense": N_DENSE_FRAMES}
    floor_us = report["floor"]["device_us"]
    for x in [report["hamming_matrix"]] + report["hamming_matrix"]["octaves"]:
        x["write_us"] = x.pop("write")["device_us"]
    print(f"floor: fill of one element {floor_us} us on the device", flush=True)
    line = []
    for n, (src, rep, phase) in kernels.items():
        r = report[n]
        # the order of the redesigns: device time over the bound per frame of
        # the phase's path, which launches the kernel equally at each of its
        # shapes (an octave's, or nullvec9's B = 512 and B = 2)
        shapes = [r] + r.get("octaves", [])
        over_us = (by_phase[phase][n] / frames[phase] / len(shapes)
                   * sum(x["device_us"] - 1e3 * x["bound_ms"] for x in shapes))
        print(f"rank {n}: {over_us} us a frame over its bound on the {phase} "
              "path", flush=True)
        line.append({
            "name": n, "route": "cuda", "source": f"rso_torch/csrc/{src}",
            "replaces": rep, "launches": by_phase[phase][n],
            "launches_phase": phase,
            "launches_by_phase": {p: c.get(n, 0) for p, c in by_phase.items()},
            "over_bound_us_per_frame": over_us, "floor_us": floor_us, **r})
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
