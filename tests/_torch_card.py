"""What chip_smoke.py and the card's tests share: the bench scene and the
kernels' operands on it, each kernel's card check against its twin
(`check_kernel`, `check_lanes`), device timing, and the bundle-adjustment
and mesh helpers.

The dependencies point one way: chip_smoke.py imports this module and
tests/_torch_*_cases.py, and both import rso_torch; no test imports
chip_smoke.  Like every test_torch_* file that runs under --noconftest on a
GPU host, this module imports no jax and nothing under `rso`.
"""
from __future__ import annotations

import collections
import contextlib
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
# the bench scene: rso/cli/bench.py's frames (1241x376, 2000 points, speed
# 0.8, the KITTI camera), N_FRAMES of them (its frames depend on the count)
H, W = 376, 1241
N_FRAMES = 30
# the lanes of the batched kernels' operands (KITTI 00-10's count)
N_LANES = 11
# kernel 1's window on its two-pass wide path (KLT_win past the one-tile
# path's widest, 45) that chip_smoke.py's wide-window run takes
WIDE_WIN = 46
# Oriented descriptors on the card against the CPU's: atan2, cos and sin
# differ in the last ulp between the CPU and CUDA, so a sample pair that
# nearly ties can flip a bit (measured against the reference: 3 bits in
# 2048 descriptors); at most this share of the bits may differ.
DESC_BIT_SHARE = 1e-3


# ---- device timing ---------------------------------------------------------

# profiler sessions device_times may take before it gives up (one session
# in ten once dropped one launch of 100 on an H100)
PROFILE_ATTEMPTS = 3
# The floors beside the kernels' times: PyTorch's fill kernel, found by its
# functor's symbol (`at::native::FillFunctor<float>`), timed on one element
# (`floor_us`, the least a launch takes) and on kernel 5's [K,K] output
# (`write_us`, the least a kernel that writes that output takes).
FILL_KERNEL = "FillFunctor"


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median ms of fn() by CUDA events around each call."""
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
    of its function.  jobs: [(kernel, fn)], where kernel may be a tuple of
    the kernels one call launches (their durations summed per call: kernel
    1's wide path launches two).  Every job runs in ONE
    torch.profiler session (CUDA activity, CUPTI): on an H100, a sixth
    session in one process once recorded no device event at all.  The
    kernels are launched through ctypes, so they are found by their own
    symbol, demangled (`::name(`, `::name<`) or mangled (`<len>nameE`/`I`);
    launches on one stream run in issue order, so the n-th batch of `reps`
    launches of a kernel belongs to the n-th job that names it.  A session
    can also drop an event, which would shift those batches: a session whose
    counts fall short is run again, up to PROFILE_ATTEMPTS times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _, fn in jobs:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    names_of = [(k,) if isinstance(k, str) else tuple(k) for k, _ in jobs]
    n_jobs = collections.Counter(k for names in names_of for k in names)
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
    for names in names_of:
        per_call = [0.0] * reps
        for kernel in names:
            k = taken[kernel]
            taken[kernel] += 1
            for i, e in enumerate(by_kernel[kernel][k * reps:(k + 1) * reps]):
                per_call[i] += e.time_range.elapsed_us()
        t = sorted(per_call)
        out.append(t[len(t) // 2])
    return out


# ---- the bench scene and the kernels' operands on it ------------------------

def bench_cam():
    from rso_torch.geometry import StereoCamera

    return StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=W / 2.0,
                             cy_l=H / 2.0, baseline=0.5371)


def bench_scene(n_frames: int = N_FRAMES, seed: int = 0):
    from rso_torch.synthetic import make_sequence

    return make_sequence(n_frames=n_frames, n_points=2000, H=H, W=W,
                         cam=bench_cam(), speed=0.8, seed=seed)


def rank8_matrices(rng, B: int, dev):
    """[B,9,9] f32 A^T A of 8x9 normal A: PSD of rank 8, as RANSAC's
    8-point normal equations are."""
    A = torch.tensor(rng.normal(0, 1, (B, 8, 9)), dtype=torch.float32,
                     device=dev)
    return (A.transpose(1, 2) @ A).contiguous()


class BenchInputs:
    """The kernels' inputs on the bench scene, as the engine paths give them:
    the 3-octave pyramid of frame 0's left image, and per octave the
    FASTER features (left, right, stereo matches) of frames 0 and 1 and the
    FAST_ORB descriptors of both frames' left images."""

    def __init__(self, seq, dev):
        from rso_torch.frontend.detect import detect_features, octave_k_slots
        from rso_torch.frontend.pyramid import build_pyramid, to_grayscale
        from rso_torch.frontend.stereo_match import match_left_right
        from rso_torch.synthetic import mode_config, synthetic_config

        self.seq = seq
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

    def operands(self, name, o):
        """(args, kw) of kernel `name` at octave o; "... open": kernels 2
        and 3 with the mask open (1e4: every valid pair admitted, for stereo
        every one with a disparity >= 1)."""
        if name.startswith("stereo_sad_fused"):
            kw = self.stereo_kw(o)
            if name.endswith("open"):
                kw = dict(kw, max_y_diff=1e4, max_disp=1e4)
            return self.stereo_args(o), kw
        if name.startswith("track_sad_fused"):
            kw = self.track_kw
            if name.endswith("open"):
                kw = dict(kw, win_row=1e4, win_col=1e4)
            return self.track_args(o), kw
        if name == "hamming_matrix":
            return (self.descs[0][o].desc, self.descs[1][o].desc), {}
        return (self.frames[0][o][0].patch, self.frames[1][o][0].patch), {}


class BenchLanes:
    """The kernels' operands under torch.func.vmap over B lanes, as the
    batched step launches them: lane b takes bench frame b at octave 0
    (tracking, kernels 5 and 6 and LK: frame b to b + 1), kernel 1 a
    threshold a lane, kernel 4 RANSAC's 512 hypotheses a lane.  `calls`:
    launch name -> (the batched call, lane b's reference): the twin's, or
    for kernel 4 and LK the unbatched kernel's."""

    NAMES = ("corner_response", "corner_response_wide", "stereo_sad_fused",
             "track_sad_fused", "nullvec9", "hamming_matrix", "sad_matrix",
             "lk_track")

    def __init__(self, seq, dev, B: int = N_LANES):
        import _torch_lk_cases as LC
        from rso_torch import kernels as K
        from rso_torch.frontend import optical_flow as OF
        from rso_torch.frontend.detect import detect_features, octave_k_slots
        from rso_torch.frontend.pyramid import build_pyramid, to_grayscale
        from rso_torch.frontend.stereo_match import match_left_right
        from rso_torch.frontend.track import _gather_right
        from rso_torch.synthetic import mode_config, synthetic_config

        vmap, stack = torch.func.vmap, lambda xs: torch.stack(xs).contiguous()
        cfg = synthetic_config()
        self.B = B
        th = torch.tensor(cfg.detect.initial_FAST_threshold, dtype=torch.int32,
                          device=dev)
        pyr = lambda f, eye, n: build_pyramid(to_grayscale(  # noqa: E731
            torch.from_numpy(seq.frames[f][eye]).to(dev)), n)
        self.k0 = k0 = octave_k_slots(cfg.detect.orb_nfeats, 3,
                                      cfg.tpu.max_kps_per_octave)[0]
        desc_params = mode_config("fast_orb_rbr_win", upright=False).detect
        left = [pyr(f, 0, 1)[0] for f in range(B + 1)]
        feats = []
        for f, im0 in enumerate(left):
            fl = detect_features(im0, cfg.detect, k0, th, False)
            fr = detect_features(pyr(f, 1, 1)[0], cfg.detect, k0, th, False)
            feats.append((fl, fr, match_left_right(fl, fr, cfg.lr_match, W, 0.0),
                          detect_features(im0, desc_params, k0, th, True)))
        self.imgs = imgs = torch.stack(left[:B])
        self.th = ths = th + torch.arange(B, dtype=torch.int32, device=dev) % 3
        self.stereo_kw = skw = dict(
            max_y_diff=cfg.lr_match.max_y_diff, max_disp=W * 0.7,
            max_distance=float(cfg.lr_match.sad_max_distance))
        self.stereo = [(fl.patch, fr.patch, fl.xy, fr.xy, fl.valid, fr.valid)
                       for fl, fr, _, _ in feats[:B]]
        self.track_kw = tkw = dict(
            win_row=float(cfg.if_match.ifm_win_w),
            win_col=float(cfg.if_match.ifm_win_h),
            sad_max=float(cfg.if_match.sad_max_distance))
        self.track = []
        for b in range(B):
            (pl, pr, pm, _), (cl, cr, cm, _) = feats[b], feats[b + 1]
            pR_xy, pR_patch, _ = _gather_right(pr, pm.ridx)
            cR_xy, cR_patch, _ = _gather_right(cr, cm.ridx)
            self.track.append((pl.patch, cl.patch, pR_patch, cR_patch, pl.xy,
                               cl.xy, pR_xy[:, 0], cR_xy[:, 0], pm.valid,
                               cm.valid))
        sargs = [stack(x) for x in zip(*self.stereo)]
        targs = [stack(x) for x in zip(*self.track)]
        rng = np.random.default_rng(11)
        self.M = M = torch.stack([rank8_matrices(rng, 512, dev) for _ in range(B)])
        da = stack([feats[b][3].desc for b in range(B)])
        db = stack([feats[b + 1][3].desc for b in range(B)])
        pa = stack([feats[b][0].patch for b in range(B)])
        pb = stack([feats[b + 1][0].patch for b in range(B)])
        self.desc, self.patch = (da, db), (pa, pb)
        self.lk = [LC.octave_case([[pyr(f, e, 3) for e in (0, 1)]
                                   for f in (b, b + 1)], 0, b) for b in range(B)]
        lpts, lvalid = (torch.stack([c[i] for c in self.lk]) for i in (2, 3))
        lprev, lcur = ([[torch.stack([c[j][e][lvl] for c in self.lk])
                         for lvl in range(3)] for e in (0, 1)] for j in (0, 1))
        self.calls = {
            "corner_response": (
                lambda: vmap(K.corner_response_cuda)(imgs, ths),
                lambda b: K.corner_response_torch(imgs[b], ths[b])),
            "corner_response_wide": (
                lambda: vmap(lambda i, t: K.corner_response_cuda(
                    i, t, win=WIDE_WIN))(imgs, ths),
                lambda b: K.corner_response_torch(imgs[b], ths[b],
                                                  win=WIDE_WIN)),
            "stereo_sad_fused": (
                lambda: vmap(lambda *a: K.stereo_sad_fused_cuda(*a, **skw))(
                    *sargs),
                lambda b: K.stereo_sad_fused_torch(*self.stereo[b], **skw)),
            "track_sad_fused": (
                lambda: vmap(lambda *a: K.track_sad_fused_cuda(*a, **tkw))(
                    *targs),
                lambda b: K.track_sad_fused_torch(*self.track[b], **tkw)),
            "nullvec9": (lambda: vmap(K.nullvec9_cuda)(M),
                         lambda b: K.nullvec9_cuda(M[b])),
            "hamming_matrix": (lambda: vmap(K.hamming_matrix_cuda)(da, db),
                               lambda b: K.hamming_matrix_torch(da[b], db[b])),
            "sad_matrix": (lambda: vmap(K.sad_matrix_cuda)(pa, pb),
                           lambda b: K.sad_matrix_torch(pa[b], pb[b])),
            "lk_track": (
                lambda: vmap(OF.lk_track_eyes)(lprev, lcur, lpts, lvalid),
                lambda b: OF.lk_track_eyes(*self.lk[b])),
        }


# ---- each kernel's card check ---------------------------------------------
# The one comparison of each kernel with its twin on the card: its gpu tests
# and chip_smoke.py's phases 3 and 3b call these, and nothing else holds a
# kernel to its twin.

# kernels whose every output equals the twin's bit for bit
BIT_KERNELS = ("corner_response", "corner_response_wide", "stereo_sad_fused",
               "track_sad_fused", "hamming_matrix", "sad_matrix")
# kernel 4 (tests/test_kernels.py's criteria): unit norm within
# NULLVEC_NORM_ATOL, the twin's direction up to sign within NULLVEC_COS_TOL,
# a null residual ||M x|| / tr(M) under NULLVEC_RESID
NULLVEC_NORM_ATOL = 1e-4
NULLVEC_COS_TOL = 1e-3
NULLVEC_RESID = 1e-3


def check_kernel(name, got, want, what=None, **ctx):
    """Hold kernel `name`'s output `got` to its twin's `want` on the same
    operands; raises AssertionError on a mismatch.  Kernels 1-3, 5 and 6
    (BIT_KERNELS): bit for bit; nullvec9 (ctx M, the matrices): the NULLVEC_*
    criteria; gn_iter (ctx start, the carry both began from):
    _torch_gn_cases.same_carry; lk_track (ctx width, height, optional conv):
    _torch_lk_cases.agree; ransac (ctx p1, p2, mask, key, H): the kernel's
    intermediates by ransac_probe, then _torch_ransac_cases.compare.
    Returns what LK's and RANSAC's comparisons measured, else None."""
    what = what or name
    if name in BIT_KERNELS:
        return same_bits(what, got, want)
    if name == "nullvec9":
        M = ctx["M"]
        cos = (got * want).sum(-1).abs().min().item()
        norm = (got.norm(dim=-1) - 1).abs().max().item()
        resid = ((M @ got[..., None])[..., 0].norm(dim=-1)
                 / M.diagonal(dim1=-2, dim2=-1).sum(-1)).max().item()
        if not (cos > 1 - NULLVEC_COS_TOL and norm <= NULLVEC_NORM_ATOL
                and resid < NULLVEC_RESID):
            raise AssertionError(f"{what}: least |cos| {cos}, norm gap {norm}, "
                                 f"residual {resid}")
        return None
    if name == "gn_iter":
        import _torch_gn_cases as GC

        return GC.same_carry(got, want, what, ctx["start"])
    if name == "lk_track":
        import _torch_lk_cases as LC

        return LC.agree(got, want, ctx["width"], ctx["height"], ctx.get("conv"))
    if name == "ransac":
        import _torch_ransac_cases as RC
        from rso_torch.kernels.ransac import ransac_probe

        p1, p2, mask, key, H = (ctx[k] for k in ("p1", "p2", "mask", "key", "H"))
        out, probe = ransac_probe(p1, p2, mask, key, n_iters=H,
                                  threshold=RC.THRESHOLD)
        same_bits(f"{what}: the probe's launch", out, tuple(got))
        keys = key.keys(p1.shape[0]) if hasattr(key, "keys") else key
        return RC.compare(got, probe, want, p1, p2, mask, keys, H)
    raise KeyError(name)


def check_lanes(name, out, lane, B, M=None) -> None:
    """A batched launch's output `out` against each lane's reference
    `lane(b)` (BenchLanes.calls): bit for bit; kernel 4's lanes, the
    unbatched kernel's, also held to the twin by check_kernel (M: the
    lanes' matrices)."""
    from rso_torch import kernels as K

    for b in range(B):
        want = lane(b)
        got = out[b] if torch.is_tensor(out) else tuple(x[b] for x in out)
        same_bits(f"{name} lane {b}", got, want)
        if name == "nullvec9":
            check_kernel(name, got, K.nullvec9_torch(M[b]), f"{name} lane {b}",
                         M=M[b])


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


# ---- the pose solver's 6x6 normal matrices ---------------------------------

def gn_normal_matrices(rng, B, cond, dev):
    """[B,6,6] f32 symmetric PSD matrices with eigenvalues log-uniform over
    `cond` (its ends included; cond 0: rank 3), scaled by 1e2-1e8 as the
    GN's are."""
    Q, _ = np.linalg.qr(rng.standard_normal((B, 6, 6)))
    if cond == 0:
        ev = np.concatenate([np.zeros((B, 3)), rng.uniform(1, 10, (B, 3))], 1)
    else:
        ev = np.exp(rng.uniform(0, np.log(cond), (B, 6)))
        ev[:, 0], ev[:, -1] = 1.0, cond
    ev = ev * 10.0 ** rng.uniform(2, 8, (B, 1))
    H = (Q * ev[:, None, :]) @ Q.transpose(0, 2, 1)
    return torch.tensor((H + H.transpose(0, 2, 1)) / 2, dtype=torch.float32,
                        device=dev)


def graded_gn_matrices(rng, B, dev, n_points=300):
    """[B,6,6] f32 J^T J of the GN's kind: J the stereo reprojection
    Jacobians (left and right eye, the bench camera) of n_points points 5-40
    m deep with respect to a small rotation and a translation, so that
    rows and columns are graded (rotation ~f px/rad, translation ~f/Z
    px/m)."""
    f, baseline = 718.856, 0.5371
    P = np.stack([rng.uniform(-10, 10, (B, n_points)),
                  rng.uniform(-3, 3, (B, n_points)),
                  rng.uniform(5, 40, (B, n_points))], -1)
    X, Y, Z = np.moveaxis(P, -1, 0)
    # d(point)/d(rotation vector) = -[P]x, the same for both eyes
    zero = np.zeros_like(X)
    neg_hat = -np.stack([np.stack([zero, -Z, Y], -1),
                         np.stack([Z, zero, -X], -1),
                         np.stack([-Y, X, zero], -1)], -2)
    rows = []
    for Xe in (X, X - baseline):
        Jt = np.stack([np.stack([f / Z, zero, -f * Xe / Z**2], -1),
                       np.stack([zero, f / Z, -f * Y / Z**2], -1)], -2)
        rows.append(np.concatenate([Jt @ neg_hat, Jt], -1))
    J = np.concatenate(rows, 1).reshape(B, -1, 6)
    return torch.tensor(J.transpose(0, 2, 1) @ J, dtype=torch.float32,
                        device=dev)


def w0_rel_err_f64(H, w) -> np.ndarray:
    """|w[0] - w0| / |w0| a matrix, w0 the smallest eigenvalue of H in
    float64 (np.linalg.eigvalsh of the f32 matrices)."""
    ref = np.linalg.eigvalsh(H.double().cpu().numpy())[:, 0]
    return np.abs(w[:, 0].double().cpu().numpy() - ref) / np.abs(ref)


# eigh6's w[0] against float64: 256 matrices a case (gn_normal_matrices at
# each cond, then graded_gn_matrices, from one default_rng(EIGH6_F64_SEED))
EIGH6_F64_CASES = (1e3, 1e5, 1e6, 1e7, "graded")
EIGH6_F64_B = 256
EIGH6_F64_SEED = 16
# w[0] of eigh6 and of torch.linalg.eigh, f32 both, part by up to about
# 2.6e-7 cond relative (the twin against LAPACK's f32 eigh on the CPU, 4096
# gn_normal_matrices at cond 1e1-1e5: 3.4e-6, 2.7e-4, 2.6e-2); the bound
# allows 1e-6 cond + 1e-5, which a w[0] off by 10x fails up to cond 1e5
EIGH6_W0_RTOL = 1e-6


def eigh6_f64_cases(dev):
    """case -> the [EIGH6_F64_B,6,6] f32 matrices of EIGH6_F64_CASES."""
    r = np.random.default_rng(EIGH6_F64_SEED)
    return {c: (graded_gn_matrices(r, EIGH6_F64_B, dev) if c == "graded"
                else gn_normal_matrices(r, EIGH6_F64_B, c, dev))
            for c in EIGH6_F64_CASES}


def ate(results, gt):
    """ATE of the chained per-frame poses, coasting over invalid frames with
    the last valid motion (the reference's constant-velocity rule)."""
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


# ---- bundle adjustment and its mesh forms ----------------------------------

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


def same_solve(what, card, cpu, rerun_card, rerun_cpu, cost_on_cpu,
               pose_atol=BA_POSE_ATOL, lmk_atol=BA_LMK_ATOL,
               sides=("card", "CPU")):
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
        raise AssertionError(f"{what}: {sides[0]} and {sides[1]} differ: "
                             f"poses {dp}, landmarks {dl}, cost {c_card} "
                             f"vs {c_cpu} (the {sides[0]}'s solution in the "
                             f"{sides[1]}'s cost: {c_at})")
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
    print(f"{what}: {sides[0]} vs {sides[1]} poses {dp}, landmarks {dl}, "
          f"cost {c_card} vs {c_cpu} (the {sides[0]}'s solution in the "
          f"{sides[1]}'s cost: {c_at}), n_iters "
          f"{its}, converged {conv}"
          + ("" if floor is None else f" (parted at the noise floor: costs "
             f"{floor} at iteration {min(its)})"), flush=True)


def hold_solve(what, got, ref, parted, cost_at, **tol):
    """A sharded solve against the one-device one at same_solve's bounds:
    `parted` holds both again at the iteration where they stop apart;
    cost_at(poses, landmarks) is the one-device cost there."""
    same_solve(what, got, ref, lambda k: parted[0], lambda k: parted[1],
               cost_at, sides=("sharded", "one-device"), **tol)


def bench_ba_problem(cam, dev):
    """rso/cli/bench.py:144-152's problem (P = 8, L = 1024, from
    default_rng(0)), as run_bench builds it."""
    from rso_torch.cli.bench import bench_ba_problem as problem

    return problem(cam, dev)


def eager_ba(cam, prob, max_iters=20, kernel_param=3.0, use_robust=True,
             fix_first=True, init_lambda=1e-4, tol=1e-5, rel_meas=None,
             rel_w_rot=0.0, rel_w_trans=0.0, marg_prior=None):
    """bundle_adjust's solve run eagerly (levenberg_marquardt's blocks,
    one flag read each): what the compiled solve must equal bit for bit."""
    from rso_torch.ba.ba import levenberg_marquardt

    dev = prob.poses.device
    if rel_meas is not None:
        rel_meas = torch.as_tensor(rel_meas, dtype=torch.float32, device=dev)
    return levenberg_marquardt(cam.to(dev), prob, max_iters, kernel_param,
                               use_robust, fix_first, init_lambda, tol,
                               rel_meas, rel_w_rot, rel_w_trans, marg_prior)


@contextlib.contextmanager
def eager_mesh_solves():
    """The mesh forms' solves as they ran before they were compiled:
    levenberg_marquardt's eager loop (one flag read a block) on the shard,
    then the landmarks gathered over the reduce's axis; what the captured
    mesh solve must equal bit for bit."""
    import rso_torch.ba.distributed as D
    import rso_torch.ba.window_sharded as WS
    from rso_torch.ba.ba import levenberg_marquardt

    def solve(cam, prob, *args, reduce, **kw):
        out = levenberg_marquardt(cam, prob, *args, reduce=reduce, **kw)
        return out._replace(lmks=reduce.gather(out.lmks, -2))

    compiled = D.solve_lm, WS.solve_lm
    D.solve_lm = WS.solve_lm = solve
    try:
        yield
    finally:
        D.solve_lm, WS.solve_lm = compiled


def counted_solve(solve):
    """solve() with the counters zeroed just before and read just after:
    (result, {graph_launches, lm_reads: the "lm" site's, collectives,
    launches})."""
    from rso_torch.graphs import GRAPH_LAUNCHES, reset_launches, settle_launches
    from rso_torch.mesh import COLLECTIVES
    from rso_torch.solver.robust_gn import HOST_READS

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    reset_launches()
    HOST_READS.clear()
    GRAPH_LAUNCHES.clear()
    out = solve()
    launches = dict(settle_launches())
    return out, dict(graph_launches=GRAPH_LAUNCHES["lm"],
                     lm_reads=HOST_READS["lm"], collectives=dict(COLLECTIVES),
                     launches=launches)


def mesh_solve_forms(B) -> list:
    """(form, node types of each segment) of every captured mesh solve
    (the keys of rso_torch.ba.ba._SOLVES that name a group): `_Composed`,
    one launch with WHILE nodes, or `_Blocks`, a launch a segment and a
    block."""
    from rso_torch.graphs import node_types

    return [(type(v.composed).__name__,
             [node_types(seg.graph.raw_cuda_graph()) for seg in segs])
            for key, solve in B._SOLVES.items() if key[-1] is not None
            for v in solve._variants.values() for segs in v.graphs.values()]


def problem_to(prob, dev):
    return type(prob)(*(None if t is None else t.to(dev) for t in prob))


class CallRecorder:
    """Wraps module.attribute to keep each call's arguments and result
    (read after the run, so the timed frames sync no more)."""

    def __init__(self, module, attribute):
        self.module, self.attribute, self.calls = module, attribute, []

    def __enter__(self):
        self.inner = getattr(self.module, self.attribute)
        setattr(self.module, self.attribute,
                lambda *args, **kw: self._call(args, kw))
        return self

    def _call(self, args, kw):
        out = self.inner(*args, **kw)
        self.calls.append((args, kw, out))
        return out

    def __exit__(self, *exc):
        setattr(self.module, self.attribute, self.inner)


def n_solve_graphs(B) -> int:
    """The CUDA graphs the compiled BA solves of this process hold."""
    return sum(s.n_graphs for s in B._SOLVES.values())


def same_bits(what, a, b):
    """Two tensors, or tuples (NamedTuples) of them field by field, bit for
    bit."""
    if torch.is_tensor(b):
        a, b = (a,), (b,)
    bad = [f for f, x, y in zip(getattr(b, "_fields", range(len(b))), a, b)
           if not torch.equal(x, y)]
    if bad or len(a) != len(b):
        raise AssertionError(f"{what}: {bad} differ")


def parted_at(a, b):
    """The iteration where two BAResults stop apart, else None."""
    if (int(a.n_iters), bool(a.converged)) == (int(b.n_iters),
                                               bool(b.converged)):
        return None
    return min(int(a.n_iters), int(b.n_iters))


def to_cpu(result):
    return type(result)(*(t.cpu() for t in result))


def lm_loop_iterations(n_iters: int, max_iters: int) -> int:
    """The iterations the LM loop ran for a solve of n_iters (two
    all_reduces each on a mesh): whole blocks of LM_BLOCK, up to the block
    that stopped it."""
    from rso_torch.ba.ba import LM_BLOCK

    b = min(LM_BLOCK, max_iters)
    return b * min(-(-n_iters // b), -(-max_iters // b))
