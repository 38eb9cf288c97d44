#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rso_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. device: CUDA must be available; prints the card's name and power limit;
  2. build: compiles rso_torch/csrc/*.cu with nvcc and loads the library;
  3. kernels: the calls of every CUDA kernel at the engine paths' shapes
     (tests/_torch_card.BenchInputs: the bench frames' octaves and
     features; kernel 4 at B = 512 and B = 2; gn_iter at a kitti frame's
     [1, 896]; lk_track at kitti_flow's three calls; ransac at
     RANSAC_SHAPES), each call first held to its twin's on the same
     operands by the kernel's card check (tests/_torch_card.check_kernel,
     the one comparison its gpu tests also call), then timed in phase 12:
     `ms`, the median call time over 50 calls after 5 of warm-up (CUDA
     events around the Python wrapper, so it includes the host's work
     before the launch is queued: library lookup, operand checks, output
     allocation, the ctypes call);
     `device_us`, the median of the kernel's own duration on the card
     (torch.profiler's CUDA activity); the same call times of the twin and,
     where one PyTorch call computes the same function, of that call; and
     the kernel's bound, the least time the card could take for the same
     work (vobench.roofline's peaks).  The stereo and tracking kernels'
     bounds count the SAD only on the pairs their masks admit (their share
     is printed, and the all-pairs bound beside it); both kernels are also
     timed with the mask open (1e4); the Hamming matrix's library call is
     torch.cdist(p=0) on the descriptors unpacked to 0/1 floats; two
     floors are timed beside the kernels: `floor_us`, PyTorch's fill of
     one element, and the Hamming matrix's `write_us`, the fill of its
     [K,K] output; kernel 1 also at win 45 (the widest window of its
     one-tile path), 46 and 64 (its two-pass wide path, reported as
     `corner_response_wide`).  The kernels' other card cases (odd shapes,
     degenerate inputs, graphs) are in their gpu test files
     (tests/test_torch_cuda.py, test_torch_gn_iter.py,
     test_torch_lk_cuda.py, test_torch_ransac_cuda.py);
 3b. batched kernels: each kernel under torch.func.vmap over N_BATCH = 11
     lanes as the batched step launches it (tests/_torch_card.BenchLanes:
     lane b bench frame b at octave 0, tracking and kernels 5-6 b to
     b + 1, kernel 4 512 matrices a lane; gn_iter one frame's [896] slots
     and carry a lane; lk_track octave 0's call of frame b to b + 1 a
     lane; ransac the flat filter's call a lane), each batched launch held
     to its lanes' references (tests/_torch_card.check_lanes: each lane
     bit for bit; gn_iter's lanes to the plain iteration by check_kernel)
     and timed beside the single one, its bound summed over the lanes
     (`batched` in the kernels line);
  4. engine, default path: 30 frames of the bench scene (1241x376, 2000
     points, speed 0.8, fx 718.856, baseline 0.5371) through
     Engine(synthetic_config()) on the card, with every kernel's launch
     counter reset just before and read just after; then the first 5 steps
     again on the CPU (the plain path) from the same states, held to the
     GPU's counts, error codes and poses.  Engine runs its step as one
     composed CUDA graph a frame (rso_torch.graphs: the GN loops as
     conditional WHILE nodes, detect_every's branch as IF nodes, every
     solve backend), captured in each phase's warm-up, so phases 4-11 drive
     the graphs; each engine run holds every frame to no host read and one
     graph launch, and prints them and the graphs captured;
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
     frame of the compiled step's stages (rso_torch.metrics.profiler's
     STAGES: stage 1 with the remap, detection, propagation, stereo,
     tracking with refine or flow's association, flow's LK calls (`lk`),
     RANSAC, the solve, its GN blocks, the update) from its stage clock
     over 5 more frames:
       kitti         configs/kitti.ini (subpixel refine on), 20 bench frames;
       rectified     configs/euroc.ini through compute_rectify_maps on the
                     distorted rig of make_unrectified_sequence at EuRoC's
                     752x480, 20 frames;
       flow          OPTICAL_FLOW tracking, 20 bench frames (kernel 3 never,
                     kernel 4 on flow's per-octave RANSAC, the LK kernel
                     once an octave for both eyes);
       detect_every  detect_every=3, 21 bench frames (kernels 1 and 2 on the
                     detect frames only);
       eigh_lm       the eigh solve with LM damping, 10 bench frames (eigh6's
                     routine in the GN kernel);
     then the seams: precomputed features and matches against the full step
     (3 frames, equal results), a checkpoint round trip on the card,
     reset_ids, and a repeat after a chunk; then
       textured      textured_config() on make_textured_sequence (seed 0)
                     at 1241x376 with the bench camera, 20 frames;
       wide_window   the same frames with KLT_win 46, 3 frames: every
                     kernel-1 launch on the wide path, and the CPU re-run of
                     each step (detection equal);
     the valid count within 3 frames and the ATE within a factor 2 of the
     reference's, either way;
 8b. the compiled step: for the default, kitti, textured, flow,
     detect_every, descriptor and eigh_lm paths, the eager make_step loop
     and Engine's composed CUDA graph from the same first state on the same
     frames (20; detect_every 21, eigh_lm 10), every field of every frame
     equal (torch.equal), the same launches over the run, and in the graph
     no host read and one graph launch a frame; per path each form's
     median step ms (CUDA events) and wall ms a frame, the flag reads a
     frame, the GN iteration distribution and the graphs; eigh_lm's eager
     step (the GN kernel, eigh6's routine inside) also against the same
     step with the plain GN iterations on cuSOLVER's eigh (pose within
     EIGH_POSE_ATOL where the counts agree, frames that part named and held
     to LANE_GN_*), and the condition numbers its normal matrices reached;
 8c. the batched step (rso_torch.parallel.BatchEngine: torch.func.vmap of
     the step over the sequences, CUDA graphs): (a) N_BATCH = 11 sequences
     of the bench scene (seeds 0-10) at 1241x376, 20 frames: 6/3/3/2
     launches a frame for all lanes, 5 graphs captured, no host read and
     one graph launch a frame, each
     lane's valid count and ATE held to phase 4's bounds and each lane
     frame to an Engine alone's (`_lane_vs_alone`: the counts equal; every
     integer field too and floats within LANE_POSE_ATOL and LANE_RES_ATOL
     where the GN ran the same iterations, else LANE_GN_*, the frames
     printed), frames/s of all lanes batched, as 11 Engines in turn
     (graphs) and as the eager step lane after lane; (b) 3 lanes on the
     kitti (20 frames), detect_every (21; lane 1 forced to detect where the
     others propagate, so the mixed body runs: the frames each branch body
     ran, counted on the device) and eigh_lm (10) paths, each after a
     warm-up frame: no host read and one graph launch a frame, launches a
     call site a frame, every lane against an Engine alone, lane 0 within
     PATH_REF;
  9. bundle adjustment (rso_torch.ba; no kernel of its own: its products
     are cuBLAS GEMMs and one cuSOLVER or batched cuBLAS LU solve an LM
     iteration; on the card the step is an LU solve of the identity times
     b), its LM loop as a conditional WHILE node of one CUDA graph a solve
     (rso_torch.ba.ba.solve_lm; a replayed solve: no host read, one graph
     launch),
     every graph solve equal to the eager loop bit for bit (poses,
     landmarks, cost, n_iters, converged); bounds from the reference's own
     CPU run (`tests/_torch_ba.py`):
       (a) the bench's BA problem (rso/cli/bench.py:144-152: P = 8,
           L = 1024 from default_rng(0)), bundle_adjust(max_iters=15) on
           the card (its first call: warm-up and capture; then a replay)
           and on the CPU from the same inputs, held together; BA
           iterations/s as the slope of the call time between 25 and 75
           iterations at tol=0 (CUDA events, best of 3, in turns), in
           graphs and eager; the flag reads;
       (b) VOWithBA at its defaults (8 keyframes, 1024 landmarks, 15
           iterations) over the 30 bench frames, twice: run 1 captures
           each solve's shape, run 2 replays them (and equals run 1 frame
           by frame); launches of kernels 1-4 held to the default path's
           counts, keyframe and solve counts to the reference's within
           BA_SLACK, finite costs, ATE; per run ms a frame with and without
           a solve (their difference: the stall per BA keyframe), each
           solve's ms and whether it captured, the flag reads a solve, and
           the host stages around the solve (keyframe_obs, build_problem,
           apply_result); the last solve again on the CPU from the card's
           BAProblem;
       (c) marginalize=True with a 4-keyframe window: evictions, a finite,
           symmetric prior, finite costs; its solves first of shape or
           replayed (P = 4 repeats with the prior);
       (d) KeyframeCollector over a plain run, refine_trajectory(window=8,
           overlap=2): its windows solved as one batch on the card, ATE of
           VO and of the refined trajectory; the call's ms in graphs (the
           first call, a replay, a capture with no warm-up) and eager, the
           trajectories equal bit for bit;
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
       (e) rso-fleet --synthetic 2 --frames 30 --chunk 8, its sequences
           one batched step: 6/3/3/2 launches a frame for both, sequence
           0's trajectory within TRAJ_ATOL of (a)'s; its JSON summary line;
       (f) rso-stages --iters 10 at 1241x376: the span table;
       (g) run_bench at 1241x376, 2000 points, 60 frames, 2 passes: its JSON
           on a line of its own, the reference's keys, finite values;
       (h) rso-demo --live on loopback (the overlay only with cv2): a
           client sees frames on /state, the page's token, /frame.jpg, a
           wrong token refused, and `q` on /control ends the run with 0;
 11. the mesh forms (rso_torch.ba.distributed, window_sharded, multihost,
     parallel's 'seq' mesh) and the host oracles.  NCCL takes one rank per
     card, so (a) and (d) run one NCCL rank in this process and (b)-(c)
     run ranks of this script (`--mesh-rank`) that share the card through
     gloo, which stages CUDA tensors through the host:
       (a) one NCCL rank: distributed_bundle_adjust on 9a's problem as a
           compiled solve (its all_reduces and landmark gather in one CUDA
           graph) equals the eager mesh loop and bundle_adjust bit for
           bit, at its first call and at a replay, which is one graph
           launch with no LM host read and counts two all_reduces an
           iteration, one before the loop and one gather; BA iterations/s
           as 9a's slope for the compiled solve, the eager mesh loop and
           bundle_adjust in the same call;
       (b) 4 gloo ranks (gloo's collectives run on the host, so the
           compiled solve runs eagerly there, by rule: no graph launch,
           a flag read a block): the same problem with its landmarks split
           four ways, and 9d's offline windows on a (2,2) ('win','lmk') mesh,
           each held to the one-device solve with phase 9's bounds; the
           collectives of each group counted (none on 'win' inside the
           loop); iterations/s as (a)'s slope, ms per all_reduce of the
           reduced system and of the cost;
       (c) 2 of those ranks on a 'seq' mesh: BatchEngine over two bench-
           scene sequences (seeds 0, 1; 10 frames at 1241x376), each
           rank's one lane held to an Engine alone as phase 8c's lanes,
           6/3/3/2 launches a frame on each rank; then rso-fleet --synthetic
           2 --frames 30 --chunk 8 over the two ranks: mesh_devices 2,
           trajectories within TRAJ_ATOL of 10e's;
       (d) rso-demo --ba --ba-distributed on 10c's layout at one rank:
           trajectory, keyframes and every solve equal to 10c's --ba run;
           each solve after the first of its window size one graph launch
           with no LM host read;
       (e) rso_torch.native built with g++; kernel 1's FAST mask on bench
           frame 0 at the default threshold equals the C++ FAST-12 as a
           set, kernels 5 and 6 at K = 512 equal the C++ matrices, and
           windowed_sad_search on the card (K = 512 templates of frame 0,
           +-8 px around their centers in frame 1, interior centers) equals
           the C++ tracking_SAD's best centers and SADs;
 12. timing: phase 3's and 3b's call times, then their device times in one
     profiler session, last, since a profiler session slows the process
     after it; each octave-shaped kernel is also timed at the other
     octaves' shapes (`octaves`; the null vectors at the refit's B = 2
     beside B = 512), and
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
import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
import _torch_card as tc  # noqa: E402
from _torch_card import N_FRAMES, REPO, WIDE_WIN, H, W  # noqa: E402
from vobench.roofline import PEAK_BYTES, PEAK_OPS, corner_ops  # noqa: E402
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
# fast_orb_rbr_win 30`): 28 valid frames, ATE 0.0835021 m.  The port's
# valid count may differ by up to REF_VALID_SLACK either way and its ATE
# lie within a factor REF_ATE_FACTOR either way (`within_reference`):
# free-running trajectories part through ulp-level differences.
DESC_REF_VALID = 28
DESC_REF_ATE = 0.0835021
# Phase 8: frames per path, and the bounds of each from the reference's own
# CPU run of the same frames and configuration (rso.engine.Engine, JAX on
# the CPU: `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_paths.py
# PATH N_FRAMES`): (valid frames, ATE m), held as phase 5's.  The bounds of
# phases 5 and 8 are two-sided: a bound that only caps the loss cannot see
# the port part from the reference in its favour, as the detect_every path
# did on the card (18 valid frames of 21 against the reference's 15).  The
# port on the CPU matches the reference's 15 there
# (`tests/_torch_detect_every.py`): the card's run parts from the CPU's at
# the RANSAC filter's near-ties (ROADMAP Queue 3).
REF_VALID_SLACK = 3
REF_ATE_FACTOR = 2.0
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
    "textured": (19, 0.01990080636273349),
}
# The textured corridor (make_textured_sequence, seed 0, at the bench size
# and camera under textured_config()): its frames per run, and the frames
# of the run that takes kernel 1's wide path at tc.WIDE_WIN (detection
# only, so it has no reference bounds: its launches and its CPU re-run are
# held).
N_TEXTURED_FRAMES = 20
N_WIDE_FRAMES = 3
# The compiled step: frames per path (detect_every: N_EVERY_FRAMES).
N_COMPILED_FRAMES = 20
# eigh_lm's step (the GN kernel, eigh6's routine inside) against the same
# step with cuSOLVER's eigh (torch.linalg.eigh, eager on the card): the
# pose within EIGH_POSE_ATOL where the GN ran the same iterations (two f32
# eigensolvers of one H, ~1e-6 apart on the bench scene's normal
# matrices); frames whose integer fields part are named and held to
# LANE_GN_*
EIGH_POSE_ATOL = 1e-5
# Phase 8c, the batched step: KITTI 00-10's count of sequences, frames each,
# frames of the eager lane-after-lane form (the slowest, timed on fewer),
# and the lanes of the kitti, detect_every and eigh_lm runs.  A lane against
# an Engine alone: integer fields equal; floats within rso's own batch
# test's pose bound (tests/test_parallel.py) and the engine tolerances,
# since the batched GN sums (its einsums, the batched Cholesky) round
# otherwise than a lone step's.  The flat RANSAC filter's normalisation sums
# over the points as a pairwise tree on the card (rso_torch.solver.ransac
# `_sum_points`), so a lane's tracks are a lone step's.
N_BATCH = 11
N_BATCH_FRAMES = 20
N_BATCH_EAGER_FRAMES = 3
N_BATCH_PATH = 3
LANE_POSE_ATOL = 1e-5
LANE_RES_ATOL = 5e-3
# A lane whose GN stopped an iteration apart from the lone step's (its
# stopping test |dx| < min_mod_out_vector = 1e-3 on sums that round
# otherwise): the pose moves by about that last step, and a residual at the
# inlier threshold may flip.
LANE_GN_POSE_ATOL = 1e-3
LANE_GN_INLIERS = 2
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
BA_SYM_RTOL = 1e-12
BA_WARM_FRAMES = 10
# what the entry-point phase holds against the earlier phases' runs: each
# engine path's StepResults by name (drive), and the BA runs' counts
RUNS = {}
# scenes made by one phase and driven again by a later one
SCENES = {}

def _bound(ops: float, n_bytes: float):
    """(bound_ms, bound_by): the larger of operations over the f32 peak and
    bytes (each input read once, each output written once) over the memory
    rate, at vobench.roofline's peaks."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def stereo_bound(args, kw):
    """(ops, bytes, admitted pairs) of the stereo function on these inputs:
    the mask on every pair (~10 operations), the SAD only on the admitted
    ones (3 operations a patch value) and its gate and merge (~4); each
    operand read once, three [Kl] outputs written."""
    Kl, P = args[0].shape
    Kr = args[1].shape[0]
    n = tc.stereo_mask_pairs(args, kw)
    return (Kl * Kr * 10 + n * (3 * P + 4),
            4 * (Kl + Kr) * (P + 2) + Kl + Kr + 12 * Kl, n)


def track_bound(args, kw):
    """(ops, bytes, admitted pairs) of the tracking function on these
    inputs: the mask on every pair (~10 operations), the SAD only on the
    admitted ones (6 operations a patch value, both eyes); each operand read
    once, two [Kp] outputs written."""
    Kp, P = args[0].shape
    Kc = args[1].shape[0]
    n = tc.track_window_pairs(args, kw)
    return (Kp * Kc * 10 + n * P * 6, 4 * (Kp + Kc) * (2 * P + 3) + Kp + Kc
            + 8 * Kp, n)



def kernel_calls(seq, dev):
    """Phase 3: every kernel's calls at the engine paths' shapes, with the
    bound of each, each call held to its twin's on the same operands by the
    kernel's card check (tests/_torch_card.check_kernel, the one its gpu
    tests call).  Returns ({name: dict(bound_ms, bound_by, shape, ...)},
    the calls to time), the times being taken by time_kernels after the
    engines."""
    import numpy as np
    import torch

    from rso_torch import kernels as K

    bi = tc.BenchInputs(seq, dev)
    pyr, th, Ks = bi.pyr, bi.th, bi.Ks
    report = {}

    # (report entry, kernel, kernel call, twin call, library call); each
    # call binds its operands now, since it runs after the engine phases
    timed = []

    def held(name, fn, plain, what, ctx):
        """The kernel's call against its twin's, now: its card check."""
        measured = tc.check_kernel(name, fn(), plain(), f"{name} {what}", **ctx)
        print(f"kernel {name} {what}: equals its twin"
              + (f" ({measured})" if measured else ""), flush=True)

    def entry(name, fn, kernel, plain, library, ops, n_bytes, shape,
              note=None, **ctx):
        """Kernel `name`'s report, its call held to the twin's (`ctx`: the
        check's operands); its times are taken after the engines."""
        held(name, fn, plain, shape, ctx)
        bound_ms, bound_by = _bound(ops, n_bytes)
        out = report[name] = dict(bound_ms=bound_ms, bound_by=bound_by,
                                  shape=shape)
        if note:
            out["library_note"] = note
        timed.append((out, kernel, fn, plain, library))
        return out

    def octave(name, kernel, fn, ops, n_bytes, shape, plain=None, **ctx):
        """The kernel at another octave's shape, timed beside its main one:
        `octaves` in its report, for the device time per frame; held to
        `plain` where given."""
        if plain is not None:
            held(name, fn, plain, shape, ctx)
        bound_ms, bound_by = _bound(ops, n_bytes)
        d = dict(shape=shape, bound_ms=bound_ms, bound_by=bound_by)
        report[name].setdefault("octaves", []).append(d)
        timed.append((d, kernel, fn, None, None))

    def window(name, kernel, fn, plain, win, img):
        """The kernel at another window, held to its twin and timed beside
        its main one."""
        held(name, fn, plain, f"win {win} {list(img.shape)}", {})
        bound_ms, bound_by = _bound(corner_ops(win) * img.numel(),
                                    8 * img.numel())
        d = dict(win=win, shape=list(img.shape), bound_ms=bound_ms,
                 bound_by=bound_by, label=f"win {win} {list(img.shape)}")
        report[name].setdefault("windows", []).append(d)
        timed.append((d, kernel, fn, None, None))

    # ---- kernel 1: all three octaves of a bench frame; the one-tile path's
    # widest window (45), then the two-pass wide path (46, the wide-window
    # engine run's, and 64) ---------------------------------------------------
    n_px = pyr[0].numel()
    # one f32 image read, one written; corner_ops(win) operations a pixel
    for name, kernels, win in (("corner_response", "corner_response_kernel", 4),
                               ("corner_response_wide",
                                ("corner_colsum_kernel", "corner_wide_kernel"),
                                WIDE_WIN)):
        cuda, twin = (lambda img, f=f, win=win: functools.partial(
            f, img, th, win=win) for f in (K.corner_response_cuda,
                                           K.corner_response_torch))
        entry(name, cuda(pyr[0]), kernels, twin(pyr[0]), None,
              corner_ops(win) * n_px, 8 * n_px, list(pyr[0].shape),
              "no single PyTorch call computes FAST + Shi-Tomasi")
        for img in pyr[1:]:
            octave(name, kernels, cuda(img), corner_ops(win) * img.numel(),
                   8 * img.numel(), list(img.shape), twin(img))
        # the one-tile path's widest window (45); the wide path's at 64
        w = 45 if win == 4 else 64
        window(name, kernels,
               functools.partial(K.corner_response_cuda, pyr[0], th, win=w),
               functools.partial(K.corner_response_torch, pyr[0], th, win=w),
               w, pyr[0])

    # ---- kernels 2, 3: real features of bench frames 0 and 1 per octave; the
    # bound counts the SAD of the admitted pairs only, the all-pairs count
    # (K^2 (3P + 8) and K^2 (6P + 10) operations) kept beside it for
    # comparison with ratios taken against it; each also with its mask open
    K0, P = Ks[0], 64
    for name, kernel, bound, pairs, all_ops, mask, opened, note in (
            ("stereo_sad_fused", "stereo_sad_kernel", stereo_bound,
             tc.stereo_mask_pairs, 3 * P + 8, "mask",
             dict(max_y_diff=1e4, max_disp=1e4), "the masked best/second"),
            ("track_sad_fused", "track_sad_kernel", track_bound,
             tc.track_window_pairs, 6 * P + 10, "window", dict(win=1e4),
             "the windowed argmin")):
        cuda, twin = getattr(K, f"{name}_cuda"), getattr(K, f"{name}_torch")
        for o in range(3):
            a, kw = bi.operands(name, o)
            open_kw = bi.operands(f"{name} open", o)[1]
            n_pairs = Ks[o] * Ks[o]
            print(f"kernel {name} K={Ks[o]}: the {mask} admits "
                  f"{pairs(a, kw)} of {n_pairs} pairs "
                  f"({pairs(a, kw) / n_pairs}), the open {mask} "
                  f"{pairs(a, open_kw) / n_pairs}", flush=True)
            ops, n_bytes, n_adm = bound(a, kw)
            fn, plain = (functools.partial(f, *a, **kw) for f in (cuda, twin))
            if o:
                octave(name, kernel, fn, ops, n_bytes, [Ks[o], Ks[o], P], plain)
                continue
            t = entry(name, fn, kernel, plain, None, ops, n_bytes, [K0, K0, P],
                      f"no single PyTorch call computes {note}")
            ops_o, _, n_open = bound(a, open_kw)
            t_open = dict(label=f"open {mask}", **opened,
                          admissible_share=n_open / (K0 * K0),
                          bound_ms=_bound(ops_o, n_bytes)[0])
            t.update(admissible_share=n_adm / (K0 * K0),
                     bound_all_pairs_ms=_bound(K0 * K0 * all_ops, n_bytes)[0],
                     **{f"open_{mask}": t_open})
            print(f"kernel {name} K={K0}: bound {t['bound_ms']} ms "
                  f"({t['bound_by']}), the SAD counted on the {n_adm} admitted "
                  f"pairs ({n_adm / (K0 * K0)}); the earlier count, the SAD on "
                  f"all pairs: {t['bound_all_pairs_ms']} ms; open {mask}: bound "
                  f"{t_open['bound_ms']} ms, {n_open} pairs admitted",
                  flush=True)
            fn, plain = (functools.partial(f, *a, **open_kw)
                         for f in (cuda, twin))
            held(name, fn, plain, f"open {mask}", {})
            timed.append((t_open, kernel, fn, None, None))

    # ---- kernel 4: 9x9 null vectors, B = 512 (2 eyes x 256) and 2 (the
    # refit; below 32 a thread reads its own matrix) ---------------------------
    # ~900 operations a matrix: LDL^T (~490), two inverse iterations
    # (~380), the regularisation; 81 floats in, 9 out.  The plain RANSAC
    # path launches it once at B = 512 (2 eyes x 256 hypotheses) and once at
    # B = 2 (the refit of each eye's best): the second shape (the engine's
    # RANSAC kernel runs its routine inline).
    rng = np.random.default_rng(0)
    Ms = {B: tc.rank8_matrices(rng, B, dev) for B in (512, 2)}
    M = Ms[512]
    entry("nullvec9", lambda M=M: K.nullvec9_cuda(M), "nullvec9_kernel",
          lambda M=M: K.nullvec9_torch(M), lambda M=M: torch.linalg.eigh(M),
          512 * 900, 512 * (81 + 9) * 4, [512, 9, 9], M=M)
    M = Ms[2]
    octave("nullvec9", "nullvec9_kernel", lambda M=M: K.nullvec9_cuda(M),
           2 * 900, 2 * (81 + 9) * 4, [2, 9, 9],
           lambda M=M: K.nullvec9_torch(M), M=M)

    # ---- kernel 5: Hamming on FAST_ORB descriptors of frames 0 and 1 --------
    # the library call: torch.cdist with p = 0 counts the differing entries
    # of the descriptors unpacked to 256 0/1 floats (unpacked before it is
    # timed; equal to the kernel: tests/test_torch_cuda.py)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    unpack = lambda d: ((d[:, :, None] >> shifts) & 1).reshape(  # noqa: E731
        d.shape[0], -1).float()
    a, b = bi.descs[0][0].desc, bi.descs[1][0].desc
    bits_a, bits_b = unpack(a), unpack(b)
    # the fill of the same [K,K] output: write_us
    fills = {k: torch.empty((k, k), device=dev) for k in Ks}
    entry("hamming_matrix", lambda a=a, b=b: K.hamming_matrix_cuda(a, b),
          "hamming_kernel", lambda a=a, b=b: K.hamming_matrix_torch(a, b),
          lambda x=bits_a, y=bits_b: torch.cdist(x, y, p=0),
          K0 * K0 * 8 * 3, (2 * K0 * 8 + K0 * K0) * 4, [K0, K0, 8])
    for o in (1, 2):
        a, b, k = bi.descs[0][o].desc, bi.descs[1][o].desc, Ks[o]
        octave("hamming_matrix", "hamming_kernel",
               lambda a=a, b=b: K.hamming_matrix_cuda(a, b),
               k * k * 8 * 3, (2 * k * 8 + k * k) * 4, [k, k, 8],
               lambda a=a, b=b: K.hamming_matrix_torch(a, b))
    for x, k in zip([report["hamming_matrix"]] + report["hamming_matrix"]["octaves"],
                    Ks):
        x["write"] = dict(label=f"fill {k}x{k}")
        timed.append((x["write"], tc.FILL_KERNEL, fills[k].zero_, None, None))
    report["floor"] = dict(label="fill 1")
    timed.append((report["floor"], tc.FILL_KERNEL,
                  torch.zeros(1, device=dev).zero_, None, None))

    # ---- kernel 6: SAD matrix on bench patches -------------------------------
    a, b = bi.frames[0][0][0].patch, bi.frames[1][0][0].patch
    entry("sad_matrix", lambda a=a, b=b: K.sad_matrix_cuda(a, b), "sad_kernel",
          lambda a=a, b=b: K.sad_matrix_torch(a, b),
          lambda a=a, b=b: torch.cdist(a, b, p=1), K0 * K0 * P * 3,
          (2 * K0 * P + K0 * K0) * 4, [K0, K0, P])
    for o in (1, 2):
        a, b, k = bi.frames[0][o][0].patch, bi.frames[1][o][0].patch, Ks[o]
        octave("sad_matrix", "sad_kernel",
               lambda a=a, b=b: K.sad_matrix_cuda(a, b), k * k * P * 3,
               (2 * k * P + k * k) * 4, [k, k, P],
               lambda a=a, b=b: K.sad_matrix_torch(a, b))

    # ---- the port's kernels with no Pallas counterpart -----------------------
    gn_iter_calls(dev, entry)
    lk_track_calls(dev, entry, octave)
    ransac_calls(dev, entry, octave)
    return report, timed


# gn_iter per slot, counted from the kernel's arithmetic (csrc/gn_iter.cu):
# the rotation 18, the projection 16, dP 45, the Jacobian 120, residual and
# its square 11, the robust weight 6, weight and cost 4, g 72, H's lower
# triangle 252, the residual's select 1; bytes: the landmark 12, the
# observation 16, the mask 1 and the weight 4 read, the residual 4 written
GN_ITER_OPS_PER_SLOT = 545
GN_ITER_BYTES_PER_SLOT = 37
# the camera 36, the carry's scalars and increment 48 each way
GN_ITER_FIXED_BYTES = 36 + 2 * 48



def gn_iter_bound(lanes: int, T: int):
    return (lanes * T * GN_ITER_OPS_PER_SLOT,
            lanes * (T * GN_ITER_BYTES_PER_SLOT + GN_ITER_FIXED_BYTES))


def _gn_timing_params(params):
    """`params` whose loop never stops, so that a launch timed again and
    again always runs its lane."""
    import dataclasses

    return dataclasses.replace(params, min_mod_out_vector=0.0,
                               max_incr_cost=1 << 30)


def gn_iter_calls(dev, entry) -> None:
    """The GN iteration kernel at a kitti frame's shape ([1, 896] in
    octaves of 512, 256 and 128: tests/_torch_gn_cases.py) in the cells'
    variant (robust kernel, IRLS, weights, chol), held to and timed beside
    the plain iteration (robust_gn.gn_iteration_torch) from the same
    carry."""
    import _torch_gn_cases as GC
    import rso_torch.solver.robust_gn as G
    from rso_torch.kernels import gn_iter as GI

    cam = GC.camera(dev)
    prev, cur, mask, w = GC.frame_inputs(0, dev)
    T = len(mask)
    p = _gn_timing_params(GC.params("robust"))
    lmks = GC.landmarks(prev)
    c = GC.carry(T, GC.DEFAULT_POSE, p, it=1, cost=1e9, device=dev)
    step = GI.gn_iteration_cuda(cam, lmks, cur, mask, w, p, 1 << 30,
                                G.VOEC_INCR_FUNC_COST_STG1,
                                G.VOEC_BAD_COND_NUMBER)
    plain = functools.partial(G.gn_iteration_torch, cam, lmks, cur, mask, w,
                              p, 1 << 30, G.VOEC_INCR_FUNC_COST_STG1,
                              GC.clone(c))
    ops, n_bytes = gn_iter_bound(1, T)
    entry("gn_iter", lambda: step(c), "gn_iter_kernel", plain, None, ops,
          n_bytes, [1, T], start=GC.clone(c))


# kitti_flow's LK: win 10 (21x21), 10 iterations, the seed over +-12 px
LK_WIN, LK_ITERS, LK_SEED = 10, 10, 12


def lk_bound(levels_hw, E: int, K: int):
    """(operations, bytes) of one lk_track call: E eyes of K slots tracked
    down the levels `levels_hw` ([(h, w)], octave o's first), counted as
    vobench/roofline_lk.py counts them (a keypoint-level, a seed; each
    level's two images read once, each slot's point and flag in, its
    position, status and residual out)."""
    from vobench.roofline_lk import keypoint_level_ops, seed_ops

    ops = E * K * (len(levels_hw) * keypoint_level_ops(LK_WIN, LK_ITERS)
                   + seed_ops(LK_SEED))
    pixels = sum(h * w for h, w in levels_hw)
    return ops, E * (2 * 4 * pixels + K * (8 + 1 + 8 + 1 + 4))


def lk_track_calls(dev, entry, octave) -> None:
    """The LK kernel at kitti_flow's three calls (both eyes of [512] slots
    down 3 levels, [256] down 2, [128] down 1; win 10, 10 iterations, seed
    12) on tests/_torch_lk_cases.py's scene, each held to the plain version
    (optical_flow.lk_track_torch), timed, the plain version beside octave
    0's."""
    import _torch_lk_cases as LC
    from rso_torch.frontend import optical_flow as OF

    pyr = LC.scene(dev)
    kw = dict(win=LK_WIN, iters=LK_ITERS, seed_range=LK_SEED)
    for o in range(3):
        prev, cur, pts, valid = LC.octave_case(pyr, o, 10 * o)
        fn = functools.partial(OF.lk_track_eyes, prev, cur, pts, valid, **kw)
        hw = [tuple(x.shape) for x in prev[0]]
        ops, n_bytes = lk_bound(hw, 2, LC.SLOTS[o])
        shape = [2, LC.SLOTS[o], len(hw)]
        plain = functools.partial(LC.plain, prev, cur, pts, valid, **kw)
        size = dict(width=LC.W >> o, height=LC.H >> o)
        if o == 0:
            entry("lk_track", fn, "lk_track_kernel", plain, None, ops,
                  n_bytes, shape, **size)
        else:
            octave("lk_track", "lk_track_kernel", fn, ops, n_bytes, shape,
                   plain, **size)


# RANSAC's checks: (N, valid share) of the timed shapes, N = 896 (kitti's
# flat filter) first; 256 hypotheses, both eyes
RANSAC_SHAPES = ((896, "some"), (1024, "some"), (512, "some"), (256, "some"),
                 (128, "some"))
RANSAC_H = 256


def ransac_bound(E: int, N: int, H: int, n_valid: int):
    """(operations, bytes) of one RANSAC call, counted from its steps: a
    hypothesis's 8 threefry draws (~120 integer operations each), its
    normal matrix (45 entries x 8 multiply-adds), null vector (kernel 4's
    ~900), de-normalisation (~90) and Sampson test of every valid point
    (~32); the refit's test, row and 45 multiply-adds a valid point and
    its null vector; the normalisation and the final mask (~52 a point).
    Bytes: both views and the mask read once, the mask, F, the count and
    ok written once."""
    ops = E * (H * (8 * 120 + 2 * 45 * 8 + 900 + 90 + 32 * n_valid)
               + n_valid * (32 + 8 + 2 * 45) + 900 + 52 * N)
    return ops, E * N * (2 * 2 * 4 + 1) + N + E * (9 * 4 + 4 + 1)


def ransac_calls(dev, entry, octave) -> None:
    """The RANSAC kernel at RANSAC_SHAPES on tests/_torch_ransac_cases.py's
    points, each call held to and the first timed beside the plain path
    (ransac.ransac_fundamental_torch), its twin."""
    import _torch_ransac_cases as RC
    from rso_torch.solver import ransac as R

    for i, (N, kind) in enumerate(RANSAC_SHAPES):
        p1, p2, mask = RC.case(N, 2, N, kind, dev)
        key = RC.frame_keys(3, dev)
        ops, n_bytes = ransac_bound(2, N, RANSAC_H, int(mask.sum()))
        fn, plain = (functools.partial(f, p1, p2, mask, key, n_iters=RANSAC_H)
                     for f in (R.ransac_fundamental, R.ransac_fundamental_torch))
        ctx = dict(p1=p1, p2=p2, mask=mask, key=key, H=RANSAC_H)
        if i == 0:
            entry("ransac", fn, "ransac_kernel", plain, None, ops, n_bytes,
                  [2, N, RANSAC_H], **ctx)
        else:
            octave("ransac", "ransac_kernel", fn, ops, n_bytes,
                   [2, N, RANSAC_H], plain, **ctx)


def batched_kernel_calls(seq, dev, report, timed) -> None:
    """Phase 3b: each kernel under torch.func.vmap over N_BATCH lanes, as
    the batched step launches it (tests/_torch_card.BenchLanes: lane b takes
    bench frame b at octave 0, tracking, kernels 5 and 6 and LK frame b to
    b + 1; gn_iter one frame's [896] slots and carry a lane; RANSAC the
    flat filter's call a lane), each batched launch timed beside the
    kernel's single one (`report[name]["batched"]`), its bound summed over
    the lanes' work on these inputs.  Each batched launch's output is held
    to every lane's reference first (tests/_torch_card.check_lanes, as
    test_cuda_batched_kernels_on_the_bench_lanes holds it; gn_iter's lanes
    to the plain iteration's by check_kernel, RANSAC's to lone launches bit
    for bit)."""
    import _torch_gn_cases as GC
    import _torch_lk_cases as LC
    import _torch_ransac_cases as RC
    import torch

    import rso_torch.solver.robust_gn as G
    from rso_torch import random as rrandom
    from rso_torch.kernels import gn_iter as GI
    from rso_torch.solver import ransac as R

    B = N_BATCH
    L = tc.BenchLanes(seq, dev, B)

    def lanes(name, kernel, ops, n_bytes, shape, fn=None, plain=None,
              check=None):
        """The batched launch, held to its lanes' references (`check` on
        its output, else BenchLanes' lanes), then timed."""
        if fn is None:
            fn, lane = L.calls[name]
            check = functools.partial(tc.check_lanes, name, lane=lane, B=B,
                                      M=L.M)
        check(fn())
        bound_ms, bound_by = _bound(ops, n_bytes)
        d = dict(lanes=B, shape=shape, bound_ms=bound_ms, bound_by=bound_by,
                 label=f"{B} lanes {shape}")
        report[name]["batched"] = d
        timed.append((d, kernel, fn, plain, None))
        print(f"kernel {name}: one launch for {B} lanes {shape}, each lane "
              f"its reference's; bound {bound_ms} ms ({bound_by})", flush=True)

    n_px = L.imgs.numel()
    lanes("corner_response", "corner_response_kernel", corner_ops(4) * n_px,
          8 * n_px, list(L.imgs.shape))
    for name, kernel, bound, args, kw in (
            ("stereo_sad_fused", "stereo_sad_kernel", stereo_bound, L.stereo,
             L.stereo_kw),
            ("track_sad_fused", "track_sad_kernel", track_bound, L.track,
             L.track_kw)):
        ops = n_bytes = 0
        for a in args:
            o_, b_, _ = bound(a, kw)
            ops, n_bytes = ops + o_, n_bytes + b_
        lanes(name, kernel, ops, n_bytes, [B] + list(args[0][0].shape))

    # gn_iter: lane b frame b's inputs, the carry from a start of its own
    cam = GC.camera(dev)
    p = _gn_timing_params(GC.params("robust"))
    ins = [GC.frame_inputs(b, dev) for b in range(B)]
    lmks = torch.stack([GC.landmarks(x[0]) for x in ins])
    cur, mask, w = (torch.stack([x[i] for x in ins]) for i in (1, 2, 3))
    T = cur.shape[1]
    starts = [GC.carry(T, GC.DEFAULT_POSE * (1 + 0.05 * b), p, it=1,
                       cost=1e9, device=dev) for b in range(B)]
    c = G.GNCarry(*(None if x[0] is None else torch.stack(x)
                    for x in zip(*starts)))

    def one(lm, ob, ma, wt, *leaves):
        carry = G.GNCarry(*leaves, None)
        GI.gn_iteration_cuda(cam, lm, ob, ma, wt, p, 1 << 30,
                             G.VOEC_INCR_FUNC_COST_STG1,
                             G.VOEC_BAD_COND_NUMBER)(carry)
        return carry.it

    def plain_one(lm, ob, ma, wt, *leaves):
        return tuple(G.gn_iteration_torch(cam, lm, ob, ma, wt, p, 1 << 30,
                                          G.VOEC_INCR_FUNC_COST_STG1,
                                          G.GNCarry(*leaves, None))[:-1])

    start = [x.clone() for x in c[:-1]]
    plain = lambda: torch.func.vmap(plain_one)(  # noqa: E731
        lmks, cur, mask, w, *start)

    def gn_lanes(_):
        # the carry the launch advanced in place, lane by lane, against the
        # plain iteration's from the same start
        want = plain()
        for b in range(B):
            tc.check_kernel("gn_iter", G.GNCarry(*(x[b] for x in c[:-1]), None),
                            G.GNCarry(*(x[b] for x in want), None),
                            f"gn_iter lane {b}",
                            start=G.GNCarry(*(x[b] for x in start), None))

    ops, n_bytes = gn_iter_bound(B, T)
    lanes("gn_iter", "gn_iter_kernel", ops, n_bytes, [B, T],
          lambda: torch.func.vmap(one)(lmks, cur, mask, w, *c[:-1]), plain,
          gn_lanes)

    ops, n_bytes = lk_bound([tuple(x.shape) for x in L.lk[0][0][0]], 2,
                            LC.SLOTS[0])
    lanes("lk_track", "lk_track_kernel", B * ops, B * n_bytes,
          [B, 2, LC.SLOTS[0]])

    # RANSAC: lane b its own points, mask and frame index
    N = RANSAC_SHAPES[0][0]
    cases = [RC.case(100 + b, 2, N, "some", dev) for b in range(B)]
    p1, p2, rmask = (torch.stack([x[i] for x in cases]) for i in range(3))
    frame = torch.arange(B, dtype=torch.int32, device=dev) + 30

    def call(a, b, m, f):
        return tuple(R.ransac_fundamental(a, b, m, rrandom.FrameKeys(f, 1000),
                                          n_iters=RANSAC_H))

    ops = n_bytes = 0
    for b in range(B):
        o, nb = ransac_bound(2, N, RANSAC_H, int(rmask[b].sum()))
        ops, n_bytes = ops + o, n_bytes + nb
    lanes("ransac", "ransac_kernel", ops, n_bytes, [B, 2, N, RANSAC_H],
          lambda: torch.func.vmap(call)(p1, p2, rmask, frame),
          check=lambda out: tc.check_lanes("ransac", out, lambda b: call(
              p1[b], p2[b], rmask[b], frame[b]), B))
    lanes("nullvec9", "nullvec9_kernel", B * 512 * 900,
          B * 512 * (81 + 9) * 4, list(L.M.shape))
    k0 = L.k0
    lanes("hamming_matrix", "hamming_kernel", B * k0 * k0 * 8 * 3,
          B * (2 * k0 * 8 + k0 * k0) * 4, list(L.desc[0].shape))
    P = L.patch[0].shape[-1]
    lanes("sad_matrix", "sad_kernel", B * k0 * k0 * P * 3,
          B * (2 * k0 * P + k0 * k0) * 4, list(L.patch[0].shape))


def time_kernels(timed) -> None:
    """Phase 12: the call times (CUDA events) of every kernel, twin and
    library call, then the kernels' own device times, all in one profiler
    session.  It runs last: after a torch.profiler session the same process
    steps the engine ~25% slower (measured on an H100: 52.1 and 47.7 ms a
    default step before one, 60.9 and 67.0 ms after), and call times, which
    include the host's work, would read high too."""
    for out, _, fn, plain, library in timed:
        out["ms"] = tc.median_ms(fn)
        if plain is not None:
            out.update(plain_ms=tc.median_ms(plain),
                       library_ms=tc.median_ms(library) if library else None)
    us = tc.device_times([(kernel, fn) for _, kernel, fn, _, _ in timed])
    for (out, kernel, *_), u in zip(timed, us):
        out["device_us"] = u
        what = out["label"] if "label" in out else out["shape"]
        print(f"time {kernel} {what}: device {u} us, call {out['ms']} ms, "
              f"bound {out.get('bound_ms')} ms", flush=True)


def drive(name, cfg, seq, dev, n_frames, maps=None):
    """One engine path on the card: warm-up, then n_frames from a fresh
    state with the launch counters reset just before and read just after.
    `maps`: the rectification maps.  Returns (states, results, launches,
    ATE); the results are also kept in RUNS[name]."""
    import torch

    from rso_torch.engine import Engine
    from rso_torch.graphs import GRAPH_LAUNCHES
    from rso_torch.graphs import reset_launches, settle_launches
    from rso_torch.solver.robust_gn import HOST_READS

    lefts = [torch.from_numpy(l).to(dev) for l, _ in seq.frames[:n_frames]]
    rights = [torch.from_numpy(r).to(dev) for _, r in seq.frames[:n_frames]]
    eng = Engine(cfg, seq.cam, rectify_maps=maps)   # the default device: the card
    if eng.device.type != "cuda":
        raise AssertionError(f"Engine's default device is {eng.device}")
    # warm-up (allocator, library)
    warm = [eng.process_frame(lefts[i], rights[i]) for i in range(3)]
    eng.reset()
    torch.cuda.synchronize()

    reset_launches()
    HOST_READS.clear()
    GRAPH_LAUNCHES.clear()
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
    launches = dict(settle_launches())
    reads = {k: v / n_frames for k, v in HOST_READS.items()}
    n_graphs = eng._get_step(*lefts[0].shape[:2]).n_graphs
    graph_launches = GRAPH_LAUNCHES["step"] / n_frames
    # every frame after the warm-up's capture: one graph launch, no read
    if sum(reads.values()) != 0 or graph_launches != 1:
        raise AssertionError(f"{name}: host reads a frame {reads}, graph "
                             f"launches a frame {graph_launches}")

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
    ate = tc.ate(results, seq.poses)
    n_valid = sum(bool(r.valid) for r in results)
    print(f"engine {name}: {n_frames} frames, valid {n_valid}/{n_frames}, "
          f"ATE {ate} m, median step {med} ms ({1e3 / med} frames/s), wall "
          f"{n_frames / wall} frames/s, launches {launches}, host reads a "
          f"frame {sum(reads.values())}, graph launches a frame "
          f"{graph_launches}, CUDA graphs captured {n_graphs}", flush=True)
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


def within_reference(name, n_valid, ate, ref) -> None:
    """A run's valid count and ATE against the reference's CPU run of the
    same frames, `ref` = (valid, ATE): within REF_VALID_SLACK frames and a
    factor REF_ATE_FACTOR, either way."""
    ref_valid, ref_ate = ref
    if (abs(n_valid - ref_valid) > REF_VALID_SLACK
            or not ref_ate / REF_ATE_FACTOR <= ate <= REF_ATE_FACTOR * ref_ate):
        raise AssertionError(f"{name}: valid {n_valid} (reference "
                             f"{ref_valid}), ATE {ate} (reference {ref_ate})")


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
        "corner_response", "ransac") + fused,
        zero=("hamming_matrix", "sad_matrix", "nullvec9"))
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
        "corner_response", "ransac"), zero=fused + ("sad_matrix", "nullvec9"),
        exact={"hamming_matrix": 6 * N_FRAMES})   # 3 octaves x (stereo + track)
    n_valid = sum(bool(r.valid) for r in results)
    within_reference("fast_orb_rbr_win", n_valid, ate,
                     (DESC_REF_VALID, DESC_REF_ATE))
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
    expect_launches("orb_bf_bf", launches, positive=("ransac",),
                    zero=fused + ("sad_matrix", "corner_response", "nullvec9"),
                    exact={"hamming_matrix": 3 * N_MODE_FRAMES})
    cpu_rerun("orb_bf_bf", cfg, seq, states, results, N_MODE_FRAMES)
    out["orb_bf_bf"] = launches

    cfg = mode_config("klt_sad_sad")
    states, results, launches, _ = drive("klt_sad_sad", cfg, seq, dev,
                                         N_MODE_FRAMES)
    expect_launches("klt_sad_sad", launches, positive=("ransac",),
                    zero=("hamming_matrix", "sad_matrix", "corner_response",
                          "nullvec9"),
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
    """ms a frame of each stage of the compiled step, from its stage clock
    (rso_torch.metrics.profiler.STAGE_CLOCK: marks in the composed graph,
    device time summed by stage on the device), and of the whole step
    (CUDA events around each call), over n_frames after the frame that
    captures the marked graph."""
    import torch

    from rso_torch.engine import Engine
    from rso_torch.metrics.profiler import STAGE_CLOCK

    frames = [(torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev))
              for l, r in seq.frames[:n_frames + 1]]
    eng = Engine(cfg, seq.cam, rectify_maps=maps)
    STAGE_CLOCK.on = True
    try:
        eng.process_frame(*frames[0])
        STAGE_CLOCK.reset()
        steps = []
        for l, r in frames[1:]:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            eng.process_frame(l, r)
            b.record()
            steps.append((a, b))
        ns = dict(STAGE_CLOCK.settle()[0])
    finally:
        STAGE_CLOCK.on = False
        STAGE_CLOCK.reset()
    n = len(steps)
    out = {stage: v * 1e-6 / n for stage, v in ns.items()}
    out["step"] = sum(a.elapsed_time(b) for a, b in steps) / n
    print(f"stages {name}: ms a frame of the compiled step's stages over {n} "
          f"frames (its stage clock; step: CUDA events around each call) "
          f"{json.dumps(out)}", flush=True)
    return out


def _launch_counts(cfg, states, results, every=1):
    """The launches a path's run should make, from its states: kernel 1
    twice an octave (both eyes) and kernel 2 once an octave on each frame
    that detects; kernel 3 once an octave on every frame unless the path
    tracks by flow; kernel 4 twice (hypotheses and refit) for each RANSAC
    call: the flat filter once a frame, or flow's per-octave filter; the LK
    kernel once an octave (both eyes in one launch) on every frame of flow
    and on each frame that propagates."""
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
            "ransac": (O if flow else 1) * n, "nullvec9": 0,
            "lk_track": O * (n if flow else n - detects),
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
    within_reference(name, n_valid, ate, ref)
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
    from rso_torch.graphs import reset_launches, settle_launches
    from rso_torch.synthetic import synthetic_config

    cfg = synthetic_config()
    O = cfg.n_octaves
    Ks = octave_k_slots(cfg.detect.orb_nfeats, O, cfg.tpu.max_kps_per_octave,
                        cfg.tpu.octave_slot_decay)
    budgets = octave_budget(cfg.detect.orb_nfeats, O)
    frames = [(torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev))
              for l, r in seq.frames[:n_frames]]
    full, feats_eng, match_eng = (Engine(cfg, seq.cam) for _ in range(3))

    reset_launches()
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
        tc.same_bits(f"seams: precomputed feats frame {i}",
                     feats_eng.process_precomputed(left, right, img_hw=(H, W)),
                     want)
        m = [(np.flatnonzero(o.matches.valid.cpu().numpy()),
              o.matches.ridx.cpu().numpy()[o.matches.valid.cpu().numpy()])
             for o in full.state.prev.octaves]
        got = match_eng.process_precomputed(left, right, matches=m,
                                            img_hw=(H, W))
        tc.same_bits(f"seams: precomputed matches frame {i}", got, want)
    launches = dict(settle_launches())
    print(f"seams: 3 frames of precomputed features and of precomputed "
          f"matches equal to the full step's results, launches {launches}",
          flush=True)
    expect_launches("seams", launches, positive=(
        "corner_response", "stereo_sad_fused", "track_sad_fused", "ransac"))

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
    tc.same_bits("seams: a step from the loaded checkpoint",
                 back.process_frame(*frames[3]), full.process_frame(*frames[3]))

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
    tc.same_bits("seams: repeat after a chunk",
                 chunk.process_frame(*frames[3], repeat=True),
                 plain.process_frame(*frames[3]))
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
    out.update(run_textured(dev))
    return out


def run_textured(dev):
    """The textured corridor at the bench size, then kernel 1's wide path
    through the engine; returns {phase: launches}."""
    import dataclasses

    from rso_torch.synthetic import make_textured_sequence, textured_config

    t0 = time.perf_counter()
    tseq = make_textured_sequence(n_frames=N_TEXTURED_FRAMES, H=H, W=W,
                                  cam=tc.bench_cam())
    print(f"textured: {N_TEXTURED_FRAMES} frames of the corridor rendered at "
          f"{W}x{H} in {time.perf_counter() - t0} s", flush=True)
    SCENES["textured"] = tseq
    cfg = textured_config()
    out = {"textured": _path_phase("textured", cfg, tseq, dev,
                                   N_TEXTURED_FRAMES, PATH_REF["textured"])}

    # kernel 1's wide path on the engine's main path: KLT_win past 45
    cfg = cfg.replace(detect=dataclasses.replace(cfg.detect, KLT_win=WIDE_WIN))
    states, results, launches, _ = drive("wide_window", cfg, tseq, dev,
                                         N_WIDE_FRAMES)
    expect, _ = _launch_counts(cfg, states, results)
    expect["corner_response_wide"] = expect.pop("corner_response")
    expect_launches("wide_window", launches, exact=expect,
                    zero=("corner_response",))
    print(f"engine wide_window (KLT_win {WIDE_WIN}): detected "
          f"{[r.detected_feats.tolist() for r in results]}, launches "
          f"{launches}", flush=True)
    cpu_rerun("wide_window", cfg, tseq, states, results, N_WIDE_FRAMES)
    out["wide_window"] = launches
    return out


def _timed_frames(run, frames):
    """Each frame through run(left, right) -> StepResult: the results, the
    launches of the run (read after it: the composed graphs count the
    launches inside their conditional nodes on the device), each frame's
    host reads and graph launches, the median step ms after frame 0 (CUDA
    events around each call) and the wall ms a frame (host clock to a
    synchronize)."""
    import torch

    from rso_torch.graphs import GRAPH_LAUNCHES
    from rso_torch.graphs import reset_launches, settle_launches
    from rso_torch.solver.robust_gn import HOST_READS

    out, reads, events = [], [], []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for left, right in frames:
        HOST_READS.clear()
        GRAPH_LAUNCHES.clear()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out.append(run(left, right))
        b.record()
        reads.append(dict(HOST_READS, graph_launches=GRAPH_LAUNCHES["step"]))
        events.append((a, b))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / len(frames)
    launches = dict(settle_launches())
    times = sorted(a.elapsed_time(b) for a, b in events[1:])
    return out, launches, reads, times[len(times) // 2], wall


def _frame_launches(run, frames):
    """Each frame through run(left, right) -> StepResult: the results and
    each frame's launches, the composed graphs' device counts settled after
    every frame (a synchronize a frame, so not a timed pass)."""
    from rso_torch.graphs import reset_launches, settle_launches

    out, launches = [], []
    for left, right in frames:
        reset_launches()
        out.append(run(left, right))
        launches.append(dict(settle_launches()))
    return out, launches


def _same_frames(what, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        tc.same_bits(f"{what}: frame {i}", g, w)


def compiled_path(name, cfg, seq, dev, n_frames) -> dict:
    """The eager make_step loop and Engine's composed CUDA graph from the
    same first state on the same frames: every field of every frame equal
    and the same launches frame by frame (an untimed pass), then again over
    a timed run; in the graph, no host read and one graph launch a frame;
    each form's median step ms and wall ms a frame,
    the flag reads a frame, the GN iteration distribution, the graphs.  The
    eigh backend's run is also held to the same step with cuSOLVER's eigh
    (`eigh_against_the_library`)."""
    import torch

    import rso_torch.solver.robust_gn as G
    from rso_torch.engine import Engine, init_state, make_step

    frames = [(torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev))
              for l, r in seq.frames[:n_frames]]
    hw = tuple(frames[0][0].shape[:2])
    eng = Engine(cfg, seq.cam)
    step = make_step(cfg, eng.cam, *hw)
    st = [init_state(cfg, hw, dev)]

    def eager(left, right):
        st[0], res = step(st[0], left, right)
        return res

    for left, right in frames[:2]:
        eager(left, right)
    st[0] = init_state(cfg, hw, dev)
    for left, right in frames[:2]:      # the warm-up and the capture
        eng.process_frame(left, right)
    eng.reset()
    want, e_frames = _frame_launches(eager, frames)
    got, g_frames = _frame_launches(eng.process_frame, frames)
    _same_frames(f"compiled {name}", got, want)
    bad = [(i, g, e) for i, (g, e) in enumerate(zip(g_frames, e_frames))
           if g != e]
    if bad:
        raise AssertionError(f"compiled {name}: (frame, graph, eager) "
                             f"launches {bad}")
    st[0] = init_state(cfg, hw, dev)
    eng.reset()
    timed, e_launch, e_reads, e_ms, e_wall = _timed_frames(eager, frames)
    _same_frames(f"compiled {name} timed eager", timed, want)
    got, g_launch, g_reads, g_ms, g_wall = _timed_frames(eng.process_frame,
                                                         frames)
    _same_frames(f"compiled {name} timed", got, want)
    if g_launch != e_launch:
        raise AssertionError(f"compiled {name}: launches {g_launch} in the "
                             f"graph, {e_launch} eager")
    bad = [i for i, r in enumerate(g_reads)
           if r.pop("graph_launches") != 1 or sum(r.values()) != 0]
    if bad:
        raise AssertionError(f"compiled {name}: frames {bad} read the host "
                             f"or launched other than one graph: {g_reads}")
    n_graphs = eng._get_step(*hw).n_graphs
    sets = 2 if cfg.tpu.detect_every > 1 else 1
    if n_graphs < 3 * sets or eng._get_step(*hw).n_composed != 1:
        raise AssertionError(f"compiled {name}: {n_graphs} graphs")
    mean = lambda rs, k: sum(r.get(k, 0) for r in rs) / len(rs)  # noqa: E731
    report = {
        "frames": n_frames, "eager_ms": e_ms, "graph_ms": g_ms,
        "eager_wall_ms": e_wall, "graph_wall_ms": g_wall,
        "gn_reads_per_frame": {"eager": mean(e_reads, "gn"),
                               "graph": mean(g_reads, "gn")},
        "detect_reads_per_frame": {"eager": mean(e_reads, "detect_every"),
                                   "graph": mean(g_reads, "detect_every")},
        "graph_launches_per_frame": 1,
        "num_it": dict(sorted(collections.Counter(
            int(r.num_it) for r in want).items())),
        "num_it_final": dict(sorted(collections.Counter(
            int(r.num_it_final) for r in want).items())),
        "graphs": n_graphs, "gn_block": G.GN_BLOCK, "launches": g_launch}
    if cfg.least_squares.solve_backend == "eigh":
        report["against_cusolver"] = eigh_against_the_library(
            name, cfg, eng.cam, frames, want, dev)
    print(f"compiled {name}: the graph equals the eager step on {n_frames} "
          f"frames, launches equal frame by frame; 0 host reads and 1 graph "
          f"launch a frame; "
          f"{json.dumps(report)}", flush=True)
    return report


def eigh_against_the_library(name, cfg, cam, frames, want, dev) -> dict:
    """The eigh backend's eager step with the GN iteration kernel (`want`,
    eigh6's routine inside it) against the same step with the plain GN
    iterations on cuSOLVER's eigh (torch.linalg.eigh), on the same frames,
    each from its own states: where the integer fields agree the pose
    within EIGH_POSE_ATOL; frames where they part are named and held to
    LANE_GN_*.  Also the condition number w[5] / w[0] of every normal
    matrix the plain run factored, against the GN's _COND_MAX (1e7; the LM
    solve aborts only on a non-finite one)."""
    import torch

    import rso_torch.solver.robust_gn as G
    from rso_torch.engine import init_state, make_step

    conds = []

    def recording(H):
        w, V = torch.linalg.eigh(H)
        conds.append(w[..., 5] / w[..., 0])
        return w, V

    hw = tuple(frames[0][0].shape[:2])
    saved = G._eigh, G.gn_iteration
    G._eigh = recording
    G.gn_iteration = lambda *a: functools.partial(G.gn_iteration_torch, *a)
    try:
        step = make_step(cfg, cam, *hw)
        st, plain = init_state(cfg, hw, dev), []
        for left, right in frames:
            st, res = step(st, left, right)
            plain.append(res)
    finally:
        G._eigh, G.gn_iteration = saved
    worst, parted = {}, []
    for i, (k, c) in enumerate(zip(want, plain)):
        _lane_vs_alone(f"{name} frame {i} (kernel vs cusolver)", c, k,
                       worst, parted, pose_atol=EIGH_POSE_ATOL)
    c = torch.stack([x.reshape(()) for x in conds]).cpu()
    fin = c[torch.isfinite(c)]
    out = {"kernel_vs_cusolver": {"frames_parted": parted, "worst": worst},
           "eigensolves": len(conds),
           "cond_max": float(fin.max()) if fin.numel() else None,
           "cond_median": float(fin.median()) if fin.numel() else None,
           "cond_max_over_limit": (float(fin.max()) / G._COND_MAX
                                   if fin.numel() else None),
           "non_finite": int((~torch.isfinite(c)).sum())}
    print(f"{name}: the GN kernel against the plain iterations on cuSOLVER's "
          f"eigh, {len(frames)} frames: {json.dumps(out)}", flush=True)
    return out


def run_compiled(seq, dev) -> dict:
    """The compiled step: the graph held to the eager step on the default,
    kitti, textured, flow, detect_every, descriptor and eigh_lm paths.
    Returns the graph runs' launches."""
    import dataclasses

    from rso_torch.config import load_config
    from rso_torch.synthetic import mode_config, synthetic_config, textured_config

    rep = dataclasses.replace
    base = synthetic_config()
    paths = [
        ("default", base, seq, N_COMPILED_FRAMES),
        ("kitti", load_config(str(REPO / "configs" / "kitti.ini")), seq,
         N_COMPILED_FRAMES),
        ("textured", textured_config(), SCENES["textured"], N_COMPILED_FRAMES),
        ("flow", base.replace(if_match=rep(base.if_match, ifm_method=3)), seq,
         N_COMPILED_FRAMES),
        ("detect_every", base.replace(tpu=rep(base.tpu, detect_every=3)), seq,
         N_EVERY_FRAMES),
        ("fast_orb_rbr_win", mode_config("fast_orb_rbr_win", upright=False),
         seq, N_COMPILED_FRAMES),
        ("eigh_lm", base.replace(least_squares=rep(
            base.least_squares, solve_backend="eigh", use_lm=True)), seq,
         N_SOLVE_FRAMES),
    ]
    launches = collections.Counter()
    for name, cfg, s, n in paths:
        launches.update(compiled_path(name, cfg, s, dev, n)["launches"])
    return dict(launches)


def _lane(tree, b):
    """Lane b of a batched result or state."""
    from rso_torch.graphs import tree_map

    return tree_map(lambda t: t[b], tree)


# a lane's fields fixed before the pose solve, which no float sum of the
# solve can move
PRE_SOLVE = ("detected_feats", "stereo_matches", "tracked_feats_from_last_frame",
             "tracked_feats_from_last_KF", "track_mask")
GN_COUNTS = ("num_it", "num_it_final")


def _lane_vs_alone(what, alone, lane, worst, parted,
                   pose_atol=LANE_POSE_ATOL) -> None:
    """A lane of the batched step against an Engine running its sequence
    alone.  The fields fixed before the pose solve are equal.  Where the GN
    ran the same iterations, every integer field is equal and the floats
    within LANE_POSE_ATOL (pose) and LANE_RES_ATOL (residuals, cost);
    `worst` keeps the largest differences.  Where it did not (the batched
    GN's sums round otherwise, and its stopping test, |dx| < 1e-3, fell the
    other way: the exception LANE_GN_* bound), the frame goes to `parted`:
    validity and error code equal, each loop's count within 1, the final
    inlier masks within LANE_GN_INLIERS slots, the pose within
    LANE_GN_POSE_ATOL."""
    import torch

    ints = {f: torch.equal(x, y) for f, x, y in zip(alone._fields, alone, lane)
            if not x.dtype.is_floating_point}
    for f in PRE_SOLVE:
        if not ints[f]:
            raise AssertionError(f"{what} {f}: {getattr(lane, f).tolist()} "
                                 f"batched, {getattr(alone, f).tolist()} alone")
    d_pose = (alone.pose - lane.pose).abs().max().item()
    if all(ints.values()):
        for field, x, y in zip(alone._fields, alone, lane):
            if not x.dtype.is_floating_point:
                continue
            d = (x - y).abs().max().item() if x.numel() else 0.0
            worst[field] = max(worst.get(field, 0.0), d)
            if d > (LANE_RES_ATOL if field in ("residuals", "cost")
                    else pose_atol):
                raise AssertionError(f"{what} {field}: batched and alone "
                                     f"differ by {d}")
        return
    its = [(int(getattr(alone, f)), int(getattr(lane, f))) for f in GN_COUNTS]
    flips = [int((getattr(alone, f) != getattr(lane, f)).sum())
             for f in ("inliers", "obs_outlier")]
    parted.append(dict(frame=what, iterations_alone_batched=its,
                       inlier_flips=flips, pose=d_pose,
                       fields=[f for f, ok in ints.items() if not ok]))
    if (not ints["valid"] or not ints["error_code"]
            or any(abs(a - b) > 1 for a, b in its)
            or max(flips) > LANE_GN_INLIERS or d_pose > LANE_GN_POSE_ATOL):
        raise AssertionError(f"{what}: the GN parted beyond its bounds: "
                             f"{parted[-1]}")


def _batched_run(name, cfg, seqs, dev, n_frames, edit=None, warm=0):
    """BatchEngine over the sequences' first n_frames on the card, with the
    launch counters and host reads reset just before and read just after;
    `warm` frames first, whose answers the run must repeat (determinism).
    `edit(frame, states) -> states` changes the states before a frame.
    Returns (results, states before each frame, launches, reads a frame,
    ms a step (CUDA events), frames/s of all lanes, the engine)."""
    import torch

    from rso_torch.graphs import GRAPH_LAUNCHES
    from rso_torch.graphs import reset_launches, settle_launches
    from rso_torch.parallel import BatchEngine
    from rso_torch.solver.robust_gn import HOST_READS

    lefts = torch.stack([torch.stack([torch.from_numpy(f[0]) for f in
                                      s.frames[:n_frames]]) for s in seqs]).to(dev)
    rights = torch.stack([torch.stack([torch.from_numpy(f[1]) for f in
                                       s.frames[:n_frames]]) for s in seqs]).to(dev)
    be = BatchEngine(cfg, seqs[0].cam, batch=len(seqs), img_h=H, img_w=W)
    if be.device.type != "cuda":
        raise AssertionError(f"BatchEngine's default device is {be.device}")
    start = be.states
    warm_res = []
    for i in range(warm):
        warm_res.append(be.process_frames(lefts[:, i], rights[:, i]))
    be.states = start
    torch.cuda.synchronize()
    reset_launches()
    HOST_READS.clear()
    GRAPH_LAUNCHES.clear()
    results, states, events = [], [], []
    t0 = time.perf_counter()
    for i in range(n_frames):
        if edit is not None:
            be.states = edit(i, be.states)
        states.append(be.states)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        results.append(be.process_frames(lefts[:, i], rights[:, i]))
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(settle_launches())
    reads = {k: v / n_frames for k, v in HOST_READS.items()}
    reads["graph_launches"] = GRAPH_LAUNCHES["step"] / n_frames
    # the batched step was captured in an earlier frame (the warm-up's, or
    # frame 0): every frame one graph launch and no host read, unless the
    # run's first frame captured
    if warm and (sum(v for k, v in reads.items() if k != "graph_launches")
                 or reads["graph_launches"] != 1):
        raise AssertionError(f"{name}: reads and graph launches a frame "
                             f"{reads}")
    _same_frames(f"{name}: the warm-up's frames again", results[:warm],
                 warm_res)
    times = sorted(a.elapsed_time(b) for a, b in events[1:])
    return (results, states, launches, reads, times[len(times) // 2],
            len(seqs) * n_frames / wall, be, (lefts, rights))


def _alone(cfg, seqs, frames, dev, n_frames, edit=None):
    """Each sequence through an Engine of its own, the engines stepped in
    turn a frame (CUDA graphs; captured in a warm-up of 3 frames first):
    (results per sequence, frames/s of the timed run)."""
    import torch

    from rso_torch.engine import Engine

    lefts, rights = frames
    engines = [Engine(cfg, s.cam) for s in seqs]
    for b, eng in enumerate(engines):
        for i in range(3):
            eng.process_frame(lefts[b, i], rights[b, i])
        eng.reset()
    torch.cuda.synchronize()
    out = [[] for _ in seqs]
    t0 = time.perf_counter()
    for i in range(n_frames):
        for b, eng in enumerate(engines):
            if edit is not None and eng.state is not None:
                eng.state = edit(i, b, eng.state)
            out[b].append(eng.process_frame(lefts[b, i], rights[b, i]))
    torch.cuda.synchronize()
    return out, len(seqs) * n_frames / (time.perf_counter() - t0)


def run_batched(seq, dev, smi) -> dict:
    """Phase 8c: BatchEngine, the sequences as one batched step a frame
    (torch.func.vmap of the step, CUDA graphs).  (a) N_BATCH sequences of
    the bench scene (seeds 0..N_BATCH-1, 30 frames each; seed 0 is phases
    4-8's `seq`) at 1241x376, the first N_BATCH_FRAMES frames,
    synthetic_config(): 6/3/3/2 launches a frame for all lanes, graphs and
    flag reads a frame, each lane's valid count and ATE (phase 4's bounds),
    each lane against an Engine alone, and frames/s of all lanes in three
    forms: batched, N_BATCH Engines in turn (graphs), and the eager step
    lane after lane; (b) N_BATCH_PATH sequences on the kitti, detect_every
    (lane 1 forced to detect on frames where the others propagate: the
    mixed graph set) and eigh_lm paths (eager, batched), each lane against
    an Engine alone and lane 0 within phase 8's PATH_REF bounds.  Returns
    the launches of (a) and of all its runs."""
    import dataclasses

    import torch

    from rso_torch.config import load_config
    from rso_torch.engine import MIXED, detect_flag, init_state, make_step
    from rso_torch.synthetic import synthetic_config

    t_phase = time.perf_counter()
    cfg = synthetic_config()
    seqs = [seq] + [tc.bench_scene(N_FRAMES, seed=s) for s in range(1, N_BATCH)]
    (results, _, launches, reads, step_ms, fps, be,
     frames) = _batched_run("batched", cfg, seqs, dev, N_BATCH_FRAMES, warm=3)
    expect_launches("batched", launches, exact=_per_frame(N_BATCH_FRAMES))
    n_graphs = be._step.n_graphs
    if n_graphs != 5:
        raise AssertionError(f"batched: {n_graphs} CUDA graphs, expected 5")
    alone, fps_alone = _alone(cfg, seqs, frames, dev, N_BATCH_FRAMES)
    worst, valid, ates, parted = {}, [], [], []
    for b, s in enumerate(seqs):
        lane = [_lane(r, b) for r in results]
        for i in range(N_BATCH_FRAMES):
            _lane_vs_alone(f"batched lane {b} frame {i}", alone[b][i], lane[i],
                           worst, parted)
        valid.append(sum(bool(r.valid) for r in lane))
        ates.append(tc.ate(lane, s.poses))
        if valid[-1] < N_BATCH_FRAMES - 3 or not ates[-1] < 1.0:
            raise AssertionError(f"batched lane {b}: valid {valid[-1]}, ATE "
                                 f"{ates[-1]}")
    # the eager step, one lane after another (the earlier BatchEngine)
    step = make_step(cfg, seqs[0].cam.to(dev), H, W)
    lefts, rights = frames
    sts = [init_state(cfg, (H, W), dev) for _ in seqs]
    for b in range(N_BATCH):                      # warm-up
        step(sts[b], lefts[b, 0], rights[b, 0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(N_BATCH_EAGER_FRAMES):
        for b in range(N_BATCH):
            sts[b], _ = step(sts[b], lefts[b, i], rights[b, i])
    torch.cuda.synchronize()
    fps_eager = N_BATCH * N_BATCH_EAGER_FRAMES / (time.perf_counter() - t0)
    per_frame = {k: v / N_BATCH_FRAMES for k, v in launches.items()}
    print(f"batched (a) {N_BATCH} sequences x {N_BATCH_FRAMES} frames at "
          f"{W}x{H} on {smi}: launches a frame {per_frame} (one per call site"
          f" for all lanes), CUDA graphs captured {n_graphs}, reads and "
          f"graph launches a frame {reads}; median batched step {step_ms} ms",
          flush=True)
    print(f"batched (a) valid per lane {valid}, ATE per lane {ates} m; every "
          f"lane's counts equal to an Engine alone's; where the GN ran the "
          f"same iterations all its integer fields, floats apart by at most "
          f"{worst}; frames where the GN parted: {len(parted)} {parted}",
          flush=True)
    print(f"batched (a) frames/s of all {N_BATCH} lanes on {smi}: batched "
          f"{fps}, {N_BATCH} Engines in turn (graphs) {fps_alone}, the eager "
          f"step lane after lane {fps_eager} ({N_BATCH_EAGER_FRAMES} frames)",
          flush=True)
    launches_a = launches
    total = collections.Counter(launches)

    # (b) the kitti, detect_every and eigh_lm paths at N_BATCH_PATH lanes
    rep = dataclasses.replace
    every = 3

    def force(i, st):
        """Lane 1 detects on frames 4 and 10 (its since_detect at
        detect_every - 1) where the others propagate."""
        if i not in (4, 10):
            return st
        since = st.since_detect.clone()
        since[1:2].fill_(every - 1)
        return st._replace(since_detect=since)

    def force_alone(i, b, st):
        if b != 1 or i not in (4, 10):
            return st
        return st._replace(since_detect=torch.full_like(st.since_detect,
                                                        every - 1))

    paths = [
        ("kitti", load_config(str(REPO / "configs" / "kitti.ini")),
         N_PATH_FRAMES, None, None),
        ("detect_every", cfg.replace(tpu=rep(cfg.tpu, detect_every=every)),
         N_EVERY_FRAMES, force, force_alone),
        ("eigh_lm", cfg.replace(least_squares=rep(
            cfg.least_squares, solve_backend="eigh", use_lm=True)),
         N_SOLVE_FRAMES, None, None),
    ]
    pseqs = seqs[:N_BATCH_PATH]
    for name, pcfg, n, edit, edit_alone in paths:
        (res, states, launches, reads, step_ms, fps, be,
         frames) = _batched_run(f"batched {name}", pcfg, pseqs, dev, n, edit,
                                warm=1)
        taken = {str(k): v for k, v in be._step.taken().items()}
        total.update(launches)
        # a call site launches once a frame for all lanes; kernels 1 and 2
        # on frames where any lane detects
        detects = sum(bool(torch.func.vmap(
            lambda st: detect_flag(pcfg, st))(st).any()) for st in states)
        O = pcfg.n_octaves
        expect_launches(f"batched {name}", launches, exact={
            "corner_response": 2 * O * detects, "stereo_sad_fused": O * detects,
            "track_sad_fused": O * n, "ransac": n, "nullvec9": 0,
            "hamming_matrix": 0,
            "sad_matrix": 0})
        alone, fps_alone = _alone(pcfg, pseqs, frames, dev, n, edit_alone)
        worst, parted = {}, []
        for b in range(N_BATCH_PATH):
            for i in range(n):
                _lane_vs_alone(f"batched {name} lane {b} frame {i}",
                               alone[b][i], _lane(res[i], b), worst, parted)
        lane0 = [_lane(r, 0) for r in res]
        n_valid, ate = sum(bool(r.valid) for r in lane0), tc.ate(lane0, pseqs[0].poses)
        within_reference(f"batched {name} lane 0", n_valid, ate, PATH_REF[name])
        sets = sorted(map(str, next(iter(be._step._variants.values())).graphs))
        if name == "detect_every" and not taken.get(str(MIXED)):
            raise AssertionError(f"batched detect_every: the mixed body never "
                                 f"ran: {taken}")
        print(f"batched (b) {name}, {N_BATCH_PATH} lanes x {n} frames on "
              f"{smi}: launches {launches} ({detects} frames detect in some "
              f"lane), reads and graph launches a frame {reads}, branch "
              f"bodies {sets}, frames each ran {taken}, CUDA graphs "
              f"captured {be._step.n_graphs}; lane 0 valid {n_valid}, ATE "
              f"{ate} (reference {PATH_REF[name]}); every lane's counts equal "
              f"to an Engine alone's, floats apart by at most {worst} where "
              f"the GN ran the same iterations; frames where it parted: "
              f"{len(parted)} {parted}; median batched step {step_ms} ms, "
              f"frames/s of all lanes {fps}, Engines in turn {fps_alone}",
              flush=True)
    print(f"phase 8c (batched step) took {time.perf_counter() - t_phase} s",
          flush=True)
    return launches_a, dict(total)


def _trajectory_ate(poses, gt):
    import numpy as np

    from rso_torch.metrics import ate_rmse

    return float(ate_rmse(np.stack(poses), gt[:len(poses)]))


class _SolveLog(tc.CallRecorder):
    """A CallRecorder of a BA solve that also keeps each call's ms (CUDA
    events around it), whether it captured graphs (the first solve of its
    key and shape: warm-up and capture) or replayed, and its graph
    launches and LM host reads."""

    def __init__(self, module, attribute):
        super().__init__(module, attribute)
        self.timing = []

    def _call(self, args, kw):
        import torch

        import rso_torch.ba.ba as B
        from rso_torch.graphs import GRAPH_LAUNCHES
        from rso_torch.solver.robust_gn import HOST_READS

        n = tc.n_solve_graphs(B)
        counts = GRAPH_LAUNCHES["lm"], HOST_READS["lm"]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = super()._call(args, kw)
        b.record()
        self.timing.append((a, b, tc.n_solve_graphs(B) > n,
                            GRAPH_LAUNCHES["lm"] - counts[0],
                            HOST_READS["lm"] - counts[1]))
        return out

    def summary(self) -> list:
        import torch

        torch.cuda.synchronize()
        return [{"P": args[1].poses.shape[-2],
                 "marg_prior": kw.get("marg_prior") is not None,
                 "captured": captured, "n_iters": int(out.n_iters),
                 "ms": a.elapsed_time(b), "graph_launches": launches,
                 "lm_reads": reads}
                for (args, kw, out), (a, b, captured, launches, reads)
                in zip(self.calls, self.timing)]


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def _vo_with_ba(cfg, cam, frames, **kw):
    """VOWithBA(cfg, cam, **kw) over the frames, the counters zeroed just
    before: its BAFrameResults, ms a frame (host clock to a synchronize),
    VO poses, launches, host reads, its solves (_SolveLog) and the ms of
    each call of the host stages around them (CUDA events)."""
    import types

    import torch

    import rso_torch.ba.pipeline as pipeline
    import rso_torch.ba.window as window_mod
    from rso_torch.ba import VOWithBA
    from rso_torch.graphs import GRAPH_LAUNCHES
    from rso_torch.graphs import reset_launches, settle_launches
    from rso_torch.solver.robust_gn import HOST_READS

    vo = VOWithBA(cfg, cam, **kw)
    stages = [(pipeline, "keyframe_obs_from_state", "keyframe_obs"),
              (window_mod.SlidingWindow, "build_problem", "build_problem"),
              (window_mod.SlidingWindow, "apply_result", "apply_result")]
    torch.cuda.synchronize()
    reset_launches()
    HOST_READS.clear()
    GRAPH_LAUNCHES.clear()
    outs, ms, vo_poses = [], [], []
    with _SolveLog(pipeline, "bundle_adjust") as log, \
            StageTimer(stages) as st:
        for left, right in frames:
            t0 = time.perf_counter()
            outs.append(vo.process_frame(left, right))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            vo_poses.append(vo.T.copy())
    solve = [o.ba_cost is not None for o in outs]
    with_s = [t for t, s in zip(ms[1:], solve[1:]) if s]
    without = [t for t, s in zip(ms[1:], solve[1:]) if not s]
    solves = log.summary()
    stage_ms = {k: [a.elapsed_time(b) for a, b in ev]
                for k, ev in st.events.items()}
    stage_ms["solve"] = [s["ms"] for s in solves]
    return types.SimpleNamespace(
        vo=vo, outs=outs, vo_poses=vo_poses, launches=dict(settle_launches()),
        lm_reads=HOST_READS["lm"], reads=sum(HOST_READS.values()),
        graph_launches=dict(GRAPH_LAUNCHES), calls=log.calls, solves=solves,
        stage_ms=stage_ms,
        ms_without=_median(without), ms_with=_median(with_s),
        stall=(None if not with_s else _median(with_s) - _median(without)),
        n_with=len(with_s), n_without=len(without))


def _same_as_eager(what, calls):
    """Each recorded graph solve equal to the eager solve of its inputs,
    bit for bit."""
    for i, (args, kw, out) in enumerate(calls):
        tc.same_bits(f"{what} solve {i} (P={args[1].poses.shape[-2]}): "
                     "graphs vs eager", out, tc.eager_ba(*args, **kw))


def run_ba(seq, dev):
    """Phase 9: bundle adjustment on the card, the LM loop as a WHILE node
    of one CUDA graph a solve (rso_torch.ba.ba.solve_lm) held to the eager
    loop.  Returns the
    launches of the first VOWithBA run."""
    import numpy as np
    import torch

    import rso_torch.ba.ba as B
    import rso_torch.ba.offline as offline
    import rso_torch.ba.window_sharded as window_sharded
    from rso_torch.ba import (KeyframeCollector, VOWithBA, bundle_adjust,
                              refine_trajectory, split_into_windows)
    from rso_torch.cli.bench import BA_REPS, BA_SLOPE_ITERS, ba_slope
    from rso_torch.engine import Engine
    from rso_torch.geometry import pose_matrix
    from rso_torch.graphs import GRAPH_LAUNCHES, CompiledStep
    from rso_torch.solver.robust_gn import HOST_READS
    from rso_torch.synthetic import synthetic_config

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    cam = seq.cam.to(dev)
    ref = BA_REF
    report = {"lm_block": B.LM_BLOCK}

    # (a) the bench's BA problem: the graphs against the eager loop and
    # against the CPU
    prob = tc.bench_ba_problem(cam, dev)
    prob_cpu = tc.problem_to(prob, cpu)
    cam_cpu = seq.cam.to(cpu)
    card = bundle_adjust(cam, prob, max_iters=15)      # warm-up + capture
    if card.poses.device.type != dev.type:
        raise AssertionError(f"bundle_adjust ran on {card.poses.device}")
    HOST_READS.clear()
    GRAPH_LAUNCHES.clear()
    replay = bundle_adjust(cam, prob, max_iters=15)
    report["bench_lm_reads"] = HOST_READS["lm"]
    report["bench_graph_launches"] = GRAPH_LAUNCHES["lm"]
    if report["bench_lm_reads"] != 0 or report["bench_graph_launches"] != 1:
        raise AssertionError(f"ba bench problem: a replayed solve read the "
                             f"host {report['bench_lm_reads']} times, "
                             f"{report['bench_graph_launches']} graph launches")
    eager = tc.eager_ba(cam, prob, max_iters=15)
    tc.same_bits("ba bench problem: the first graph solve vs eager", card, eager)
    tc.same_bits("ba bench problem: a replay vs eager", replay, eager)
    host = bundle_adjust(cam_cpu, prob_cpu, max_iters=15)
    tc.same_solve("ba bench problem P=8 L=1024, 15 iterations", card, host,
                  lambda k: bundle_adjust(cam, prob, max_iters=k),
                  lambda k: bundle_adjust(cam_cpu, prob_cpu, max_iters=k),
                  lambda p, l: bundle_adjust(cam_cpu, prob_cpu._replace(
                      poses=p, lmks=l), max_iters=0).cost)
    rate = ba_slope(cam, prob)
    eager_rate = ba_slope(cam, prob, solve=tc.eager_ba)
    for n in BA_SLOPE_ITERS:
        tc.same_bits(f"ba bench problem at tol=0, {n} iterations: graphs vs "
                     "eager", bundle_adjust(cam, prob, max_iters=n, tol=0.0),
                     tc.eager_ba(cam, prob, max_iters=n, tol=0.0))
    if rate["iters_per_sec"] is None or eager_rate["iters_per_sec"] is None:
        raise AssertionError(f"BA slope not positive: {rate['ms']}, "
                             f"eager {eager_rate['ms']}")
    report["bench"] = {"graph": rate, "eager": eager_rate}
    print(f"ba iterations/s (P=8, L=1024, slope {BA_SLOPE_ITERS[0]}-"
          f"{BA_SLOPE_ITERS[1]} iterations at tol=0, best of {BA_REPS}): "
          f"graphs {rate['iters_per_sec']} ({rate['ms_per_iter']} ms an "
          f"iteration; calls {rate['ms']} ms), eager "
          f"{eager_rate['iters_per_sec']} ({eager_rate['ms_per_iter']} ms; "
          f"calls {eager_rate['ms']} ms); graphs equal eager bit for bit; "
          f"a replayed solve of 15 iterations at LM_BLOCK {B.LM_BLOCK}: "
          f"{report['bench_lm_reads']} flag reads, "
          f"{report['bench_graph_launches']} graph launch", flush=True)

    # (b) VOWithBA at its defaults over the bench frames, twice: run 1
    # captures each solve's shape (first of shape: warm-up and capture),
    # run 2 replays them
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
    first = _vo_with_ba(cfg, seq.cam, frames)
    outs, launches = first.outs, first.launches
    expect, _ = _launch_counts(cfg, outs, outs)
    expect_launches("vo_with_ba", launches, exact=expect)
    n_kf = sum(o.is_keyframe for o in outs)
    costs = [o.ba_cost for o in outs if o.ba_cost is not None]
    if not all(np.isfinite(costs)):
        raise AssertionError(f"vo_with_ba: non-finite BA cost in {costs}")
    ate_vo = _trajectory_ate(first.vo_poses, gt)
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
    n_graphs = tc.n_solve_graphs(B)
    second = _vo_with_ba(cfg, seq.cam, frames)
    if tc.n_solve_graphs(B) != n_graphs or any(s["captured"]
                                               for s in second.solves):
        raise AssertionError("vo_with_ba run 2 captured graphs: its solves "
                             "are not run 1's shapes")
    # run 2's solves replay: one graph launch each, no read; its Engine is
    # new, so its first frame is the step's warm-up and capture
    if (second.lm_reads != 0
            or second.graph_launches.get("lm") != len(second.solves)
            or second.graph_launches.get("step") != len(frames) - 1):
        raise AssertionError(f"vo_with_ba run 2: {second.lm_reads} LM reads, "
                             f"graph launches {second.graph_launches} for "
                             f"{len(frames)} frames and {len(second.solves)} "
                             "solves")
    for i, (a, b) in enumerate(zip(first.outs, second.outs)):
        if not (np.array_equal(a.pose_wc, b.pose_wc)
                and a.ba_cost == b.ba_cost):
            raise AssertionError(f"vo_with_ba run 2 parts from run 1 at "
                                 f"frame {i}")
    _same_as_eager("vo_with_ba run 1", first.calls)
    _same_as_eager("vo_with_ba run 2", second.calls)
    for name, run in (("run 1", first), ("run 2", second)):
        rep = {"ms_without": run.ms_without, "ms_with": run.ms_with,
               "stall": run.stall, "frames_with": run.n_with,
               "frames_without": run.n_without,
               "lm_reads_per_solve": run.lm_reads / len(run.solves),
               "host_reads": run.reads,
               "graph_launches": run.graph_launches,
               "solves": run.solves,
               "stage_ms_total": {k: sum(v) for k, v in run.stage_ms.items()},
               "stage_ms_median": {k: _median(v)
                                   for k, v in run.stage_ms.items()}}
        report[f"vo_with_ba_{name.replace(' ', '')}"] = rep
        print(f"vo_with_ba {name} (ms a frame: host clock to a synchronize, "
              f"after frame 0; the solve's and the stages' ms: CUDA events "
              f"around each call): {json.dumps(rep)}", flush=True)

    # one solve again on the CPU from the card's BAProblem
    (s_cam, s_prob), s_kw, s_out = first.calls[-1]
    c_prob = tc.problem_to(s_prob, cpu)
    on_cpu = bundle_adjust(cam_cpu, c_prob, **s_kw)
    tc.same_solve(f"vo_with_ba last solve (P={s_prob.poses.shape[0]})", s_out,
                  on_cpu,
                  lambda k: bundle_adjust(s_cam, s_prob, **dict(s_kw, max_iters=k)),
                  lambda k: bundle_adjust(cam_cpu, c_prob, **dict(s_kw, max_iters=k)),
                  lambda p, l: bundle_adjust(cam_cpu, c_prob._replace(
                      poses=p, lmks=l), **dict(s_kw, max_iters=0)).cost,
                pose_atol=tc.BA_WINDOW_POSE_ATOL, lmk_atol=tc.BA_WINDOW_LMK_ATOL)

    # (c) marginalization: a 4-keyframe window evicts within the frames;
    # its solves at P = 4 repeat, with the prior, as replays
    marg_run = _vo_with_ba(cfg, seq.cam, frames, marginalize=True,
                           max_keyframes=4)
    marg, m_outs = marg_run.vo, marg_run.outs
    m_kf = sum(o.is_keyframe for o in m_outs)
    m_costs = [o.ba_cost for o in m_outs if o.ba_cost is not None]
    evictions = m_kf - len(marg.window)
    prior = marg.window.prior
    _same_as_eager("marginalized", marg_run.calls)
    rep = {"stall": marg_run.stall, "ms_without": marg_run.ms_without,
           "ms_with": marg_run.ms_with,
           "first_of_shape_ms": [s["ms"] for s in marg_run.solves
                                 if s["captured"]],
           "replay_ms": [s["ms"] for s in marg_run.solves
                         if not s["captured"]],
           "solves": marg_run.solves,
           "stage_ms_median": {k: _median(v)
                               for k, v in marg_run.stage_ms.items()}}
    report["marginalized"] = rep
    r = ref["marginalized"]
    print(f"marginalized: {m_kf} keyframes (reference {r['keyframes']}), "
          f"{evictions} evictions (reference {r['evictions']}), "
          f"{len(m_costs)} solves (reference {r['solves']}), prior over "
          f"{None if prior is None else prior.n} keyframes, ATE BA "
          f"{_trajectory_ate([o.pose_wc for o in m_outs], gt)} m (reference "
          f"{r['ate_ba']}); graphs equal eager; {json.dumps(rep)}",
          flush=True)
    if (prior is None or evictions < 1 or not np.isfinite(prior.H).all()
            or np.abs(prior.H - prior.H.T).max() > BA_SYM_RTOL
            * np.abs(prior.H).max() or not np.isfinite(m_costs).all()):
        raise AssertionError("marginalization: no eviction, or a prior that "
                             "is missing, not finite or not symmetric")

    # (d) offline refinement: keyframes of a plain run, windows in a batch;
    # refine_trajectory's call in graphs (the first: warm-up and capture;
    # again: replays), with a capture and no warm-up, and eager
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

    def refine():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = refine_trajectory(seq.cam, col.kfs, col.kf_frame_idx, poses,
                                window=8, overlap=2)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    sizes = {k: len(s._variants) for k, s in B._SOLVES.items()}
    with tc.CallRecorder(offline, "window_sharded_bundle_adjust") as solves:
        refined, first_ms = refine()
    new = [k for k, s in B._SOLVES.items()     # the batch's compiled solve
           if len(s._variants) > sizes.get(k, 0)]
    again, replay_ms = refine()
    saved = B._SOLVES[new[0]]

    class NoWarmUp(CompiledStep):
        def _run(self, v):
            if v.composed is None:
                self._capture(v)
            v.composed.launch()

    B._SOLVES[new[0]] = NoWarmUp(saved.fn)
    try:
        cold, cold_ms = refine()
    finally:
        B._SOLVES[new[0]] = saved

    def eager_lm(cam, prob, *args, **kw):
        return B.levenberg_marquardt(cam.to(prob.poses.device), prob, *args,
                                     **kw)

    window_sharded.solve_lm = eager_lm
    try:
        plain, eager_ms = refine()
    finally:
        window_sharded.solve_lm = B.solve_lm
    for what, x in (("a replay", again), ("a capture with no warm-up", cold),
                    ("the first graph call", refined)):
        if not np.array_equal(x, plain):
            raise AssertionError(f"offline: {what} parts from the eager "
                                 "refinement")
    report["offline"] = {"first_ms": first_ms, "replay_ms": replay_ms,
                         "capture_no_warm_up_ms": cold_ms,
                         "eager_ms": eager_ms, "keys": len(new)}
    batches = [(len(probs), probs[0].poses.device.type)
               for (_, probs, *_), _, _ in solves.calls]
    n = len(col.kfs)
    n_win = len(split_into_windows(n, min(8, n), min(2, min(8, n) - 1)))
    ate_off, ate_ref = _trajectory_ate(list(poses), gt), _trajectory_ate(
        list(refined), gt)
    r = ref["offline"]
    print(f"offline: {n} keyframes (reference {r['keyframes']}), {n_win} "
          f"windows solved as one batch {batches}, ATE VO {ate_off} m "
          f"(reference {r['ate_vo']}), ATE refined {ate_ref} m (reference "
          f"{r['ate_refined']}); refine_trajectory ms (host clock to a "
          f"synchronize), trajectories equal bit for bit: "
          f"{json.dumps(report['offline'])}", flush=True)
    if (batches != [(n_win, dev.type)] or n_win < 2 or len(new) != 1
            or not ate_ref <= 2 * r["ate_refined"]):
        raise AssertionError("offline refinement: not one batch of >= 2 "
                             "windows on the card, or ATE past its bound")
    (_, probs, *_), kw, _ = solves.calls[0]
    RUNS["offline"] = {"keyframes": n, "windows": n_win, "ate_vo": ate_off,
                       "ate_refined": ate_ref, "problems": (probs, kw)}
    print(f"phase 9 report: {json.dumps(report)}", flush=True)
    print(f"phase 9 (bundle adjustment) took {time.perf_counter() - t_phase} "
          "s", flush=True)
    return launches

# Phase 10, the entry points (rso_torch.cli).  DEMO_REF: the reference's own
# CPU run of (a)'s argv, `rso-demo --synthetic --frames 30` (rso.cli.demo,
# JAX on the CPU: `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_cli.py
# 30`): (valid frames, the ATE it prints, unrounded).  As for phases 5 and
# 8, the port may lose up to 3 more frames and reach twice the ATE.
N_DEMO_FRAMES = 30
# rso-fleet's trajectories (phases 10e, 11c) against runs that step their
# sequences in another batch: phase 8c's per-frame pose bound, chained over
# the demo's frames
TRAJ_ATOL = N_DEMO_FRAMES * LANE_POSE_ATOL
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
    from rso_torch.graphs import reset_launches, settle_launches

    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.redirect_stdout(buf))
        rec = ba = None
        if record:
            rec = stack.enter_context(tc.CallRecorder(Engine, "process_frame"))
            ba = stack.enter_context(tc.CallRecorder(pipeline, "bundle_adjust"))
        rc = main(argv)
    torch.cuda.synchronize()
    launches = dict(settle_launches())
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


def _traj_diff(a: Path, b: Path) -> float:
    """The largest difference of two KITTI trajectory files' entries."""
    import numpy as np

    return float(np.abs(np.loadtxt(a) - np.loadtxt(b)).max())


def _per_frame(n: int, O: int = 3) -> dict:
    """The default path's launches over n frames (6/3/3/2 a frame)."""
    return {"corner_response": 2 * O * n, "stereo_sad_fused": O * n,
            "track_sad_fused": O * n, "ransac": n, "nullvec9": 0,
            "hamming_matrix": 0,
            "sad_matrix": 0}


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
    per_frame = _per_frame

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
    ate_b = tc.ate(results, seq.poses)
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
    RUNS["demo_ba"] = {"argv": base + ["--ba"], "out": out / "c_ba.txt",
                       "keyframes": n_kf, "solves": [r for _, _, r in solves]}
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

    # (e) rso-fleet: two sequences as one batched step, chunked: one launch
    # a call site for both; sequence 0 is (a)'s within TRAJ_ATOL
    fdir = out / "fleet"
    rc, lines, launches, _, _ = _entry(fleet.main, [
        "--synthetic", "2", "--frames", str(N_DEMO_FRAMES), "--chunk",
        str(DEMO_CHUNK), "--out-dir", str(fdir)])
    total.update(launches)
    expect_launches("rso-fleet", launches, exact=per_frame(N_DEMO_FRAMES))
    summary = json.loads(lines[-1])
    d = _traj_diff(fdir / "seq_synthetic_0.txt", Path(a["txt"]))
    print(f"entry points (e) rso-fleet on {smi}: {lines[-1]}", flush=True)
    print(f"entry points (e) sequence 0 against (a)'s trajectory: max|d| {d} "
          f"m (bound {TRAJ_ATOL})", flush=True)
    if rc != 0 or not d <= TRAJ_ATOL or summary["mesh_devices"] != 1:
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


# Phase 11, the mesh forms and the host oracles.  NCCL takes one rank per
# card, so (a) and (d) run one NCCL rank in this process, and (b)-(c) run
# ranks of this script (`--mesh-rank`) that share the card through gloo,
# which stages CUDA tensors through the host.  The ranks load the library
# phase 2 built (the same sources hash to the same path).
N_MESH_RANKS = 4
N_SEQ_RANKS = 2
N_SEQ_FRAMES = 10
N_ALL_REDUCE = 50
MESH_RANK_TIMEOUT = 300
MESH_DIR = REPO / "build" / "chip_smoke" / "mesh"


def _all_reduce_ms(group, n: int, dev) -> float:
    """ms per all_reduce of n float32 on the group (host clock to a
    synchronize around N_ALL_REDUCE calls, after 5)."""
    import torch
    import torch.distributed as dist

    buf = torch.ones(n, device=dev)
    for _ in range(5):
        dist.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_ALL_REDUCE):
        dist.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / N_ALL_REDUCE


def mesh_rank(rank: int, world: int, work: Path) -> None:
    """One rank of phases 11b-c (gloo; results to work/rank<R>.pt)."""
    import contextlib
    import io

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from rso_torch.ba import (bundle_adjust, distributed_bundle_adjust,
                              make_mesh, make_win_mesh,
                              window_sharded_bundle_adjust)
    from rso_torch.ba.multihost import initialize_multihost
    from rso_torch.cli import fleet
    from rso_torch.cli.bench import ba_slope
    from rso_torch.engine import Engine
    from rso_torch.graphs import GRAPH_LAUNCHES, reset_launches, settle_launches
    from rso_torch.kernels import _lib
    from rso_torch.mesh import COLLECTIVES, make_device_mesh
    from rso_torch.parallel import BatchEngine
    from rso_torch.solver.robust_gn import HOST_READS
    from rso_torch.synthetic import synthetic_config

    _lib.load()
    dev = torch.device("cuda")
    out = {}
    initialize_multihost(f"file://{work}/store", world, rank, backend="gloo")

    # (b) the bench BA problem with its landmarks split `world` ways
    cam = tc.bench_cam().to(dev)
    prob = tc.bench_ba_problem(cam, dev)
    mesh = make_mesh()
    COLLECTIVES.clear()
    HOST_READS.clear()
    GRAPH_LAUNCHES.clear()
    got = distributed_bundle_adjust(cam, prob, mesh, max_iters=15)
    out["ba_collectives"] = dict(COLLECTIVES)
    # gloo's collectives run on the host: the solve runs eagerly, by rule
    out["ba_eager"] = dict(graph_launches=GRAPH_LAUNCHES["lm"],
                           lm_reads=HOST_READS["lm"])
    one = bundle_adjust(cam, prob, max_iters=15)
    k = tc.parted_at(got, one)
    out["ba"] = [tc.to_cpu(got), tc.to_cpu(one)] + ([] if k is None else [
        tc.to_cpu(distributed_bundle_adjust(cam, prob, mesh, max_iters=k)),
        tc.to_cpu(bundle_adjust(cam, prob, max_iters=k))])
    out["ba_rate"] = ba_slope(cam, prob, solve=lambda c, p, **kw:
                              distributed_bundle_adjust(c, p, mesh, **kw))
    P = prob.poses.shape[0]
    out["all_reduce_ms"] = {
        f"system ({P * P * 36 + P * 42} floats)": _all_reduce_ms(
            mesh.get_group("lmk"), P * P * 36 + P * 42, dev),
        "cost and bad count (2 floats)": _all_reduce_ms(
            mesh.get_group("lmk"), 2, dev)}

    # (b) phase 9d's windows on a (2, world/2) ('win','lmk') mesh
    probs, kw = torch.load(work / "windows.pt", weights_only=False)
    probs = [type(p)(*(None if t is None else t.to(dev) for t in p))
             for p in probs]
    wmesh = make_win_mesh(2, world // 2)
    COLLECTIVES.clear()
    wins = window_sharded_bundle_adjust(cam, probs, wmesh, **kw)
    out["win_collectives"] = dict(COLLECTIVES)
    batch = window_sharded_bundle_adjust(cam, probs, **kw)
    out["win"] = []
    for w, (a, b) in enumerate(zip(wins, batch)):
        k = tc.parted_at(a, b)
        out["win"].append([tc.to_cpu(a), tc.to_cpu(b)] + ([] if k is None else [
            tc.to_cpu(window_sharded_bundle_adjust(
                cam, probs, wmesh, **dict(kw, max_iters=k))[w]),
            tc.to_cpu(window_sharded_bundle_adjust(
                cam, probs, **dict(kw, max_iters=k))[w])]))
    dist.destroy_process_group()

    # (c) the 'seq' mesh of the first N_SEQ_RANKS ranks
    if rank < N_SEQ_RANKS:
        initialize_multihost(f"file://{work}/store_seq", N_SEQ_RANKS, rank,
                             backend="gloo")
        cfg = synthetic_config()
        seqs = [tc.bench_scene(N_SEQ_FRAMES, seed=s) for s in range(N_SEQ_RANKS)]
        lefts = np.stack([[f[0] for f in s.frames] for s in seqs])
        rights = np.stack([[f[1] for f in s.frames] for s in seqs])
        be = BatchEngine(cfg, seqs[0].cam, batch=N_SEQ_RANKS, img_h=H,
                         img_w=W, mesh=make_device_mesh((N_SEQ_RANKS,),
                                                        ("seq",)))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        chunk = be.process_chunk(lefts, rights)
        torch.cuda.synchronize()
        out["seq_ms"] = (time.perf_counter() - t0) * 1e3 / N_SEQ_FRAMES
        out["seq_launches"] = dict(settle_launches())
        eng = Engine(cfg, seqs[rank].cam)
        out["seq_sequences"] = list(be.sequences)
        worst, parted = {}, []
        for n, (l, r) in enumerate(seqs[rank].frames):
            _lane_vs_alone(f"mesh (c) rank {rank} frame {n}",
                           eng.process_frame(l, r),
                           _lane(type(chunk)(*(t[n] for t in chunk)), 0),
                           worst, parted)
        out["seq_equal"] = dict(worst=worst, gn_parted=parted)
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_launches()
        with contextlib.redirect_stdout(buf):
            out["fleet_rc"] = fleet.main([
                "--synthetic", "2", "--frames", str(N_DEMO_FRAMES), "--chunk",
                str(DEMO_CHUNK), "--out-dir", str(work / "fleet")])
        torch.cuda.synchronize()
        out["fleet_launches"] = dict(settle_launches())
        out["fleet_stdout"] = buf.getvalue()
        dist.destroy_process_group()
    torch.save(out, work / f"rank{rank}.pt")


def _spawn_ranks(world: int, work: Path) -> list:
    """Run `world` ranks of this script on `work`; every rank's results.
    Every rank started is waited for, or killed, before this returns."""
    import torch

    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
         str(r), str(world), str(work)], cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=MESH_RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"mesh rank {r} failed ({p.returncode}):\n"
                                 f"{log[-4000:]}")
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def run_mesh(seq, dev, smi: str) -> dict:
    """Phase 11: the mesh forms and the host oracles.  Returns the launches
    of its main-path runs (rank 0's of (c), and (d)'s)."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    import rso_torch.ba.ba as B
    import rso_torch.ba.pipeline as pipeline
    from rso_torch import native
    from rso_torch.ba import bundle_adjust, distributed_bundle_adjust, make_mesh
    from rso_torch.cli import demo
    from rso_torch.cli.bench import ba_slope
    from rso_torch.config import RSOConfig
    from rso_torch.frontend.detect import extract_patches
    from rso_torch.kernels import (corner_response_cuda, hamming_matrix_cuda,
                                   sad_matrix_cuda, windowed_sad_search)

    t_phase = time.perf_counter()
    total = collections.Counter()
    cam = seq.cam.to(dev)

    # (a) one NCCL rank (the all_reduce is a copy): the compiled mesh solve,
    # its all_reduces and landmark gather inside one graph
    mesh = make_mesh()
    if dist.get_backend() != "nccl":
        raise AssertionError("mesh (a): no NCCL group")
    prob = tc.bench_ba_problem(cam, dev)
    one = bundle_adjust(cam, prob, max_iters=15)
    with tc.eager_mesh_solves():
        eager = distributed_bundle_adjust(cam, prob, mesh, max_iters=15)
    tc.same_bits("mesh (a) the eager mesh loop on one NCCL rank vs "
                 "bundle_adjust", eager, one)
    n_graphs = tc.n_solve_graphs(B)
    first = distributed_bundle_adjust(cam, prob, mesh, max_iters=15)
    tc.same_bits("mesh (a) the compiled mesh solve's warm-up vs the eager mesh "
                 "loop", first, eager)
    captured = tc.n_solve_graphs(B) - n_graphs
    forms = tc.mesh_solve_forms(B)
    got, replay = tc.counted_solve(
        lambda: distributed_bundle_adjust(cam, prob, mesh, max_iters=15))
    tc.same_bits("mesh (a) the compiled mesh solve's replay vs the eager mesh "
                 "loop", got, eager)
    n = tc.lm_loop_iterations(int(got.n_iters), 15)
    expect = {"solve lmk": 1 + 2 * n, "gather lmk": 1}
    if (replay["graph_launches"], replay["lm_reads"],
            replay["collectives"]) != (1, 0, expect):
        raise AssertionError(f"mesh (a): a replayed solve made {replay}, "
                             f"expected 1 graph launch, 0 LM host reads and "
                             f"collectives {expect}")
    with tc.eager_mesh_solves():
        eager_rate = ba_slope(cam, prob, solve=lambda c, p, **kw:
                              distributed_bundle_adjust(c, p, mesh, **kw))
    rate = ba_slope(cam, prob, solve=lambda c, p, **kw:
                    distributed_bundle_adjust(c, p, mesh, **kw))
    plain = ba_slope(cam, prob)
    print(f"mesh (a) one {dist.get_backend()} rank (torch {torch.__version__},"
          f" NCCL {torch.cuda.nccl.version()}): distributed_bundle_adjust "
          f"(P=8, L=1024, 15 iterations) as a compiled solve ({captured} "
          f"CUDA graphs captured at its first call; form and node types of "
          f"the segments {forms}) equals the eager mesh "
          f"loop and bundle_adjust bit for bit; {int(got.n_iters)} "
          f"iterations; a replay: {replay}; BA "
          f"iterations/s (slope 25-75 at tol=0): the compiled mesh solve "
          f"{rate['iters_per_sec']} ({rate['ms_per_iter']} ms an iteration), "
          f"the eager mesh loop {eager_rate['iters_per_sec']} "
          f"({eager_rate['ms_per_iter']} ms), bundle_adjust "
          f"{plain['iters_per_sec']} ({plain['ms_per_iter']} ms), in this "
          f"call on {smi}", flush=True)
    if None in (rate["iters_per_sec"], eager_rate["iters_per_sec"]):
        raise AssertionError("mesh (a): no positive slope")

    # (b), (c): ranks sharing the card through gloo
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    probs, kw = RUNS["offline"]["problems"]
    torch.save(([type(p)(*(None if t is None else t.cpu() for t in p))
                 for p in probs], kw), MESH_DIR / "windows.pt")
    t0 = time.perf_counter()
    ranks = _spawn_ranks(N_MESH_RANKS, MESH_DIR)
    print(f"mesh (b)-(c): {N_MESH_RANKS} gloo ranks on the card took "
          f"{time.perf_counter() - t0} s", flush=True)
    def cost_at(p, l, prob=prob, **kw):
        """The one-device cost of a problem at (poses, landmarks)."""
        return bundle_adjust(cam, prob._replace(poses=p.to(dev),
                                                lmks=l.to(dev)),
                             max_iters=0, **kw).cost.cpu()

    wkw = {k: kw[k] for k in ("rel_w_rot", "rel_w_trans")}
    for r, o in enumerate(ranks):
        ours, ref, *parted = o["ba"]
        tc.hold_solve(f"mesh (b) rank {r}: the bench BA problem on "
                      f"{N_MESH_RANKS} ranks vs one", ours, ref, parted,
                      cost_at)
        tc.same_bits(f"mesh (b) rank {r} vs rank 0", ours, ranks[0]["ba"][0])
        n = tc.lm_loop_iterations(int(ours.n_iters), 15)
        expect = {"solve lmk": 1 + 2 * n, "gather lmk": 1}
        if o["ba_collectives"] != expect:
            raise AssertionError(f"mesh (b) rank {r}: collectives "
                                 f"{o['ba_collectives']}, expected {expect}")
        if o["ba_eager"]["graph_launches"] or not o["ba_eager"]["lm_reads"]:
            raise AssertionError(f"mesh (b) rank {r}: a gloo solve ran "
                                 f"{o['ba_eager']}, not eagerly")
        for w, (ours, ref, *parted) in enumerate(o["win"]):
            tc.hold_solve(f"mesh (b) rank {r}: offline window {w} on the (2,"
                          f"{N_MESH_RANKS // 2}) mesh vs the batch", ours, ref,
                          parted, lambda p, l, w=w: cost_at(
                              p, l, probs[w], rel_meas=kw["rel_meas"][w],
                              **wkw),
                        pose_atol=tc.BA_WINDOW_POSE_ATOL,
                        lmk_atol=tc.BA_WINDOW_LMK_ATOL)
        c = o["win_collectives"]
        if any(key.startswith("solve win") for key in c) or c.get(
                "gather win") != 1 or c.get("gather lmk") != 1:
            raise AssertionError(f"mesh (b) rank {r}: window collectives {c}")
    r0 = ranks[0]
    print(f"mesh (b) rank 0: gloo groups run the compiled solve eagerly (its "
          f"collectives run on the host): {r0['ba_eager']}; collectives of "
          f"the BA {r0['ba_collectives']}, "
          f"of the windows {r0['win_collectives']} (none on 'win' in the "
          f"loop); BA iterations/s (slope 25-75 at tol=0) "
          f"{r0['ba_rate']['iters_per_sec']} ({r0['ba_rate']['ms_per_iter']} "
          f"ms an iteration); ms per all_reduce {r0['all_reduce_ms']}; every "
          f"rank: {[o['ba_rate']['iters_per_sec'] for o in ranks]} "
          f"iterations/s on {smi}", flush=True)

    fleet_ref = REPO / "build" / "chip_smoke" / "cli" / "fleet"
    for r, o in enumerate(ranks[:N_SEQ_RANKS]):
        expect_launches(f"mesh (c) rank {r} BatchEngine", o["seq_launches"],
                        exact=_per_frame(N_SEQ_FRAMES))
        expect_launches(f"mesh (c) rank {r} rso-fleet", o["fleet_launches"],
                        exact=_per_frame(N_DEMO_FRAMES))
        print(f"mesh (c) rank {r}: sequences {o['seq_sequences']}, counts "
              f"equal to an Engine alone's, floats and GN partings "
              f"{o['seq_equal']}, {o['seq_ms']} ms a frame; launches "
              f"{o['seq_launches']}, rso-fleet's {o['fleet_launches']}",
              flush=True)
        if o["seq_sequences"] != [r] or o["fleet_rc"]:
            raise AssertionError(f"mesh (c) rank {r}: not an Engine alone")
    total.update(r0["seq_launches"])
    total.update(r0["fleet_launches"])
    summary = json.loads(r0["fleet_stdout"].splitlines()[-1])
    # a rank steps one lane, 10e two as one batch: within TRAJ_ATOL
    d = max(_traj_diff(MESH_DIR / "fleet" / f, fleet_ref / f)
            for f in ("seq_synthetic_0.txt", "seq_synthetic_1.txt"))
    print(f"mesh (c) rso-fleet over {N_SEQ_RANKS} ranks on {smi}: "
          f"{json.dumps(summary)}; trajectories against phase 10e's: max|d| "
          f"{d} m (bound {TRAJ_ATOL})", flush=True)
    if (summary["mesh_devices"] != N_SEQ_RANKS or not d <= TRAJ_ATOL
            or ranks[1]["fleet_stdout"] != ""):
        raise AssertionError("mesh (c) rso-fleet: not phase 10e's run")

    # (d) rso-demo --ba --ba-distributed: phase 10c's run, at one rank
    ref = RUNS["demo_ba"]
    d_out = MESH_DIR / "d_ba.txt"
    with _SolveLog(pipeline, "distributed_bundle_adjust") as solves:
        rc, lines, launches, _, _ = _entry(demo.main, ref["argv"] + [
            "--ba-distributed", "--out", str(d_out)])
    total.update(launches)
    expect_launches("mesh (d) rso-demo --ba --ba-distributed", launches,
                    exact=_per_frame(N_FRAMES))
    n_kf = int(next(x for x in lines if "keyframes in window BA" in x)
               .split()[1])
    same_traj = d_out.read_bytes() == ref["out"].read_bytes()
    outs = [o for _, _, o in solves.calls]
    same_solves = len(outs) == len(ref["solves"]) and all(
        all(torch.equal(x, y) for x, y in zip(a, b))
        for a, b in zip(outs, ref["solves"]))
    log = solves.summary()
    replays = [(s["graph_launches"], s["lm_reads"]) for s in log
               if not s["captured"]]
    print(f"mesh (d) rso-demo --ba --ba-distributed: rc {rc}, {n_kf} "
          f"keyframes and {len(outs)} solves (10c: {ref['keyframes']} and "
          f"{len(ref['solves'])}), trajectory equal to 10c's: {same_traj}, "
          f"every solve equal to 10c's: {same_solves}; {len(log) - len(replays)}"
          f" solves captured (the first of each window size), each replayed "
          f"one (graph launches, LM host reads) {replays}, ms "
          f"{[s['ms'] for s in log]}; launches {launches}", flush=True)
    if rc != 0 or not same_traj or not same_solves or n_kf != ref["keyframes"]:
        raise AssertionError("mesh (d): --ba-distributed is not --ba's run")
    if not replays or any(r != (1, 0) for r in replays):
        raise AssertionError("mesh (d): a replayed solve is not one graph "
                             "launch without host reads")
    dist.destroy_process_group()

    # (e) the host oracles against kernels 1, 5 and 6 (not counted)
    t0 = time.perf_counter()
    if not native.available():
        native._load()          # raises with the compiler's message
    print(f"mesh (e) rso_torch.native built and loaded in "
          f"{time.perf_counter() - t0} s", flush=True)
    frame = seq.frames[0][0]
    th = RSOConfig().detect.initial_FAST_threshold
    resp = corner_response_cuda(torch.from_numpy(frame).to(dev).float(), th)
    ys, xs = np.nonzero(torch.isfinite(resp).cpu().numpy())
    ours = set(zip(xs.tolist(), ys.tolist()))
    theirs = set(map(tuple, native.fast_detect(frame, th, arc=12).tolist()))
    rng = np.random.default_rng(11)
    K = 512
    xy = np.stack([rng.integers(4, W - 5, K), rng.integers(4, H - 5, K)], -1)
    img = torch.from_numpy(frame).to(dev).float()
    pa = extract_patches(img, torch.from_numpy(xy[:, :]).float().to(dev))
    pb = extract_patches(torch.from_numpy(seq.frames[1][0]).to(dev).float(),
                         torch.from_numpy(xy[::-1].copy()).float().to(dev))
    sad = sad_matrix_cuda(pa, pb).cpu().numpy()
    sad_ref = native.sad_matrix(pa.cpu().numpy().astype(np.uint8),
                                pb.cpu().numpy().astype(np.uint8))
    da = rng.integers(0, 2**32, (K, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, (K, 8), dtype=np.uint32)
    ham = hamming_matrix_cuda(torch.from_numpy(da.view(np.int32)).to(dev),
                              torch.from_numpy(db.view(np.int32)).to(dev))
    ham_ref = native.hamming_matrix(da, db)
    # windowed_sad_search (plain PyTorch on the card) against the C++
    # tracking_SAD at interior centers, where neither clamps its window:
    # frame 0's patches searched for in frame 1 around their own centers
    wx, wy = 8, 8
    cxy = np.stack([rng.integers(wx + 4, W - wx - 5, K),
                    rng.integers(wy + 4, H - wy - 5, K)], -1)
    tmpl = extract_patches(img, torch.from_numpy(cxy).float().to(dev))
    img1 = seq.frames[1][0]
    win = windowed_sad_search(torch.from_numpy(img1).to(dev).float(), tmpl,
                              torch.from_numpy(cxy).float().to(dev), wx, wy)
    t8 = tmpl.cpu().numpy().astype(np.uint8)
    oracle = np.array([native.tracking_sad(img1, t8[i], int(cxy[i, 0]),
                                           int(cxy[i, 1]), wx, wy)
                       for i in range(K)])
    ours_ws = np.concatenate([win.best_xy.cpu().numpy(),
                              win.best_sad.cpu().numpy()[:, None]], 1)
    ok = (ours == theirs,
          np.array_equal(sad.astype(np.uint32), sad_ref),
          np.array_equal(ham.cpu().numpy().astype(np.uint32), ham_ref),
          win.best_xy.device.type == "cuda"
          and np.array_equal(ours_ws, oracle.astype(np.float32)))
    print(f"mesh (e) oracles: kernel 1's FAST mask at threshold {th} on bench "
          f"frame 0 ({W}x{H}): {len(ours)} corners, the C++ FAST-12's "
          f"{len(theirs)}, equal as sets: {ok[0]}; kernel 6 at K={K}: equal "
          f"to native.sad_matrix: {ok[1]}; kernel 5 at K={K}, W=8: equal to "
          f"native.hamming_matrix: {ok[2]}; windowed_sad_search on the card, "
          f"K={K} at +-{wx}x{wy} (best SAD median {np.median(oracle[:, 2])}): "
          f"equal to native.tracking_sad: {ok[3]}", flush=True)
    if not all(ok) or not theirs:
        raise AssertionError("mesh (e): a kernel differs from its C++ oracle")
    print(f"phase 11 (mesh forms and oracles) took "
          f"{time.perf_counter() - t_phase} s", flush=True)
    return dict(total)


def main() -> int:
    import torch

    if len(sys.argv) == 5 and sys.argv[1] == "--mesh-rank":
        mesh_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (REPO / "rso_torch" / "csrc").is_dir():
        print(f"chip_smoke: no rso_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    smi = tc.nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi}", flush=True)

    from rso_torch.kernels import _lib

    t0 = time.perf_counter()
    _lib.load()
    print(f"build: {time.perf_counter() - t0:.1f} s ({_lib.library_path()})",
          flush=True)

    dev = torch.device("cuda")
    seq = tc.bench_scene(N_FRAMES)
    report, timed = kernel_calls(seq, dev)
    batched_kernel_calls(seq, dev, report, timed)
    by_phase = run_engines(seq, dev)
    by_phase.update(run_new_paths(seq, dev))
    by_phase["compiled"] = run_compiled(seq, dev)
    batched, by_phase["batched"] = run_batched(seq, dev, smi)
    by_phase["vo_with_ba"] = run_ba(seq, dev)
    by_phase["entry_points"] = run_entry_points(seq, dev, smi)
    by_phase["mesh"] = run_mesh(seq, dev, smi)
    time_kernels(timed)

    # the phase whose path each kernel's launches are read from
    kernels = {
        "corner_response": ("fast_detect.cu", "rso/kernels/fast_detect.py:146", "default"),
        "corner_response_wide": ("fast_detect.cu", "rso/kernels/fast_detect.py:146",
                                 "wide_window"),
        "stereo_sad_fused": ("stereo_fused.cu", "rso/kernels/stereo_fused.py:207", "default"),
        "track_sad_fused": ("stereo_fused.cu", "rso/kernels/stereo_fused.py:133", "default"),
        "nullvec9": ("smallchol.cu", "rso/kernels/smallchol.py:136", "default"),
        "hamming_matrix": ("distance.cu", "rso/kernels/distance.py:157", "fast_orb_rbr_win"),
        "sad_matrix": ("distance.cu", "rso/kernels/distance.py:123", "sad_dense"),
        # no Pallas kernel: rso's GN iteration is plain XLA
        "gn_iter": ("gn_iter.cu", "rso/solver/robust_gn.py:89 (_eval_rgn) "
                    "and the GN loop's body", "default"),
        # no Pallas kernel: rso's LK is plain XLA
        "lk_track": ("lk_track.cu", "rso/frontend/optical_flow.py:203",
                     "flow"),
        # no Pallas kernel: rso's RANSAC is plain XLA around kernel 4
        "ransac": ("ransac.cu", "rso/solver/ransac.py (ransac_fundamental)",
                   "default"),
    }
    frames = {"default": N_FRAMES, "fast_orb_rbr_win": N_FRAMES,
              "sad_dense": N_DENSE_FRAMES, "wide_window": N_WIDE_FRAMES,
              "flow": N_PATH_FRAMES}
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
        n_launches = by_phase[phase].get(n, 0)
        over_us = (n_launches / frames[phase] / len(shapes)
                   * sum(x["device_us"] - 1e3 * x["bound_ms"] for x in shapes))
        print(f"rank {n}: {over_us} us a frame over its bound on the {phase} "
              "path", flush=True)
        line.append({
            "name": n, "route": "cuda", "source": f"rso_torch/csrc/{src}",
            "replaces": rep, "launches": n_launches,
            "launches_phase": phase,
            "launches_by_phase": {p: c.get(n, 0) for p, c in by_phase.items()},
            # phase 8c (a): one launch a call site for all N_BATCH lanes
            "batched_lanes": N_BATCH, "batched_launches": batched.get(n, 0),
            "over_bound_us_per_frame": over_us, "floor_us": floor_us, **r})
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

