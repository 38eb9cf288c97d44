"""The CUDA kernels against their PyTorch twins, on the card.

Every test here is marked `gpu` and skips without a CUDA device.  The file
imports neither jax nor rso, so it also runs on a GPU host without jax:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: FAST masks, SAD indices and distances bit-exact (the stereo
and tracking kernels also on the cases of tests/_torch_stereo_cases.py and
tests/_torch_track_cases.py, the SAD matrix also at ragged shapes and
widths that are not a multiple of 4); the corner
response bit-exact too (same operation order, round-to-nearest intrinsics,
the same float32 reciprocal for the window mean), checked at 1e-6 against
the twin on the card and exactly against the twin on the CPU; null
vectors up to sign (|cos| > 1 - 1e-3, unit norm to 1e-4): the kernel is
LDL^T, the twin regularised Cholesky (bit for bit against the kernel's
earlier design: tests/_torch_kernel_ab.py); Hamming and SAD matrices
bit-exact (integer counts, and exact f32 sums of 1/16-multiples).  Under
torch.func.vmap each kernel launches once for all lanes, each lane bit for
bit its twin's (kernel 4: the unbatched kernel's bits); the batched engine
step (rso_torch.parallel.BatchEngine) gives each lane an Engine's integer
fields, its floats within rso's own batch test's pose bound (1e-5) and the
engine tolerances.
"""
import collections

import numpy as np
import pytest
import torch

import _torch_card as card
import _torch_stereo_cases as SC
import _torch_track_cases as TC
from rso_torch import kernels as K
from rso_torch.engine import Engine
from rso_torch.frontend.pyramid import build_pyramid, to_grayscale
from rso_torch.geometry import StereoCamera
from rso_torch.graphs import reset_launches, settle_launches
from rso_torch.synthetic import MODES, make_sequence, mode_config


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bench_seq():
    """The bench scene's frames (chip_smoke.py's), made once a module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return card.bench_scene()


@pytest.fixture(scope="module")
def bench(bench_seq):
    """The kernels' operands on the bench frames, as chip_smoke times them."""
    return card.BenchInputs(bench_seq, torch.device("cuda"))


@pytest.fixture(scope="module")
def bench_lanes(bench_seq):
    """The kernels' batched operands, as chip_smoke times them."""
    return card.BenchLanes(bench_seq, torch.device("cuda"))


def _stereo_case(k, seed, dev):
    r = np.random.default_rng(seed)
    perm = r.permutation(k)
    pl = r.integers(0, 255 * 16, (k, 64)) / 16.0
    pr = np.clip(pl[perm] + r.integers(-40, 40, (k, 64)) / 16.0, 0, 255)
    xy_l = r.uniform(10, 300, (k, 2))
    xy_r = xy_l[perm] - np.stack([r.uniform(-2, 40, k), r.uniform(-1, 1, k)], -1)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    ok = lambda: torch.tensor(r.random(k) > 0.1, device=dev)  # noqa: E731
    return f(pl), f(pr), f(xy_l), f(xy_r), ok(), ok()


@pytest.mark.gpu
@pytest.mark.parametrize("th", [10, 20, 25])
def test_cuda_corner_response(cuda, th):
    seq = make_sequence(n_frames=1, n_points=2000, H=376, W=1241)
    img = to_grayscale(torch.from_numpy(seq.frames[0][0]).to(cuda))
    for octave in build_pyramid(img, 3):
        out = K.corner_response_cuda(octave, th)
        ref = K.corner_response_torch(octave, th)
        assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
        fin = torch.isfinite(ref)
        torch.testing.assert_close(out[fin], ref[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("th", [10, 20, 25])
def test_cuda_corner_response_equals_the_cpu_twin(cuda, th):
    """Kernel 1 on the card and its twin on the CPU agree bit for bit (both
    take the correctly rounded sqrt): the engine's CPU re-runs rest on it."""
    seq = make_sequence(n_frames=1, n_points=2000, H=376, W=1241)
    for octave in build_pyramid(to_grayscale(torch.from_numpy(seq.frames[0][0])), 3):
        out = K.corner_response_cuda(octave.to(cuda), th)
        assert torch.equal(out.cpu(), K.corner_response_torch(octave, th))


@pytest.mark.gpu
@pytest.mark.parametrize("arc", [9, 12])
@pytest.mark.parametrize("win", [2, 4, 13, 45, 46, 64])
@pytest.mark.parametrize("hw", [(17, 23), (94, 310), (377, 1243)])
def test_cuda_corner_response_noise(cuda, hw, win, arc):
    """Uniform noise of odd sizes, corners up to the 3-px ring on every edge
    (partial tiles, wrapped halos, windows wider than the image): bit-exact
    with the twin on the card and on the CPU.  Win 13 and 45 take more than
    48 KB of shared memory a block (the launch opts in), 45 the most a
    block's tile holds; 46 and 64 take the two-pass wide path."""
    img = np.random.default_rng(hw[0] * hw[1]).uniform(0, 255, hw).astype(np.float32)
    cpu = torch.from_numpy(img)
    out = K.corner_response_cuda(cpu.to(cuda), 20, arc, win)
    ref = K.corner_response_torch(cpu.to(cuda), 20, arc, win)
    assert torch.isfinite(ref[3:6]).any() and torch.isfinite(ref[:, -6:-3]).any()
    assert torch.equal(out, ref)
    assert torch.equal(out.cpu(), K.corner_response_torch(cpu, 20, arc, win))


@pytest.mark.gpu
@pytest.mark.parametrize("scene,win", [
    *[pytest.param("plain", w, id=str(w)) for w in (45, 46, 64)],
    *[pytest.param("bench", w, id=f"bench-{w}") for w in (4, 45, 46, 64)]])
def test_cuda_corner_response_at_any_window(cuda, request, scene, win):
    """Kernel 1 at the default window, the widest one-tile window and past
    it, on every octave of a frame (the plain scene's at threshold 20; the
    bench scene's at the configured threshold, as chip_smoke.py times it):
    mask and response equal to the twin bit for bit, on the card and on the
    CPU; each call one launch, up to 45 on the one-tile path, 46 and 64 on
    the wide path."""
    if scene == "bench":
        bench = request.getfixturevalue("bench")
        pyr, th = bench.pyr, bench.th
    else:
        seq = make_sequence(n_frames=1, n_points=2000, H=376, W=1241)
        pyr = build_pyramid(to_grayscale(torch.from_numpy(seq.frames[0][0])
                                         .to(cuda)), 3)
        th = torch.tensor(20, dtype=torch.int32, device=cuda)
    path = "corner_response_wide" if win > 45 else "corner_response"
    for octave in pyr:
        reset_launches()
        out = K.corner_response_cuda(octave, th, win=win)
        assert dict(settle_launches()) == {path: 1}
        assert torch.isfinite(out).any()
        card.check_kernel(path, out, K.corner_response_torch(
            octave, th, win=win))
        card.check_kernel(path, out.cpu(), K.corner_response_torch(
            octave.cpu(), th.cpu(), win=win), f"{path}: the CPU twin")


@pytest.mark.gpu
@pytest.mark.parametrize("k,seed,max_distance", [
    *[pytest.param(k, k, 1200.0, id=str(k)) for k in (512, 257, 128, 1)],
    pytest.param(257, 1, 6000.0, id="257-seed1-6000")])
def test_cuda_stereo_sad_fused(cuda, k, seed, max_distance):
    args = _stereo_case(k, seed, cuda)
    kw = dict(max_y_diff=1.0, max_disp=100.0, max_distance=max_distance)
    card.check_kernel("stereo_sad_fused", K.stereo_sad_fused_cuda(*args, **kw),
                      K.stereo_sad_fused_torch(*args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("case", SC.CASES)
def test_cuda_stereo_sad_fused_cases(cuda, case):
    """The mask-first kernel on the cases of tests/_torch_stereo_cases.py:
    the engine's sparse mask, rows with nothing admissible or ok_l false
    (index 0, 1e9, 1e9), y on a .5 boundary, disparity exactly 1 and
    max_disp, a pair over max_distance, one admitted pair (second 1e9),
    equal SADs, Kl != Kr, K = 1 and the open mask.  Bit-exact with the
    twin."""
    args, kw, *_ = SC.stereo_case(case)
    a = tuple(torch.from_numpy(x).to(cuda) for x in args)
    card.check_kernel("stereo_sad_fused", K.stereo_sad_fused_cuda(*a, **kw),
                      K.stereo_sad_fused_torch(*a, **kw), case)


@pytest.mark.gpu
@pytest.mark.parametrize("k,seed,sad_max", [
    *[pytest.param(k, k, 1200.0, id=str(k)) for k in (512, 131, 128)],
    pytest.param(131, 2, 8000.0, id="131-seed2-8000")])
def test_cuda_track_sad_fused(cuda, k, seed, sad_max):
    p1, c1, xy1, xy2, okp, okc = _stereo_case(k, seed, cuda)
    p2, c2, _, _, _, _ = _stereo_case(k, seed + 1, cuda)
    args = (p1, c1, p2, c2, xy1, xy2, xy1[:, 0] - 5.0, xy2[:, 0] - 7.0, okp, okc)
    kw = dict(win_row=8.0, win_col=40.0, sad_max=sad_max)
    card.check_kernel("track_sad_fused", K.track_sad_fused_cuda(*args, **kw),
                      K.track_sad_fused_torch(*args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("case", TC.CASES)
def test_cuda_track_sad_fused_cases(cuda, case):
    """The mask-first kernel on the cases of tests/_torch_track_cases.py:
    the engine's sparse window, rows with nothing admissible or ok_p false
    (index 0, 1e9), one eye over sad_max, equal SADs, Kp != Kc, K = 1 and
    the open window.  Bit-exact with the twin."""
    args, kw, rows, cols = TC.track_case(case)
    a = tuple(torch.from_numpy(x).to(cuda) for x in args)
    card.check_kernel("track_sad_fused", K.track_sad_fused_cuda(*a, **kw),
                      K.track_sad_fused_torch(*a, **kw), case)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [512, 2, 1, 31, 32, 33, 129])
def test_cuda_nullvec9(cuda, B):
    """Full and partial blocks of 32 hypotheses: the twin's direction up to
    sign, unit norm, and a null residual ||M x|| / tr(M) < 1e-3
    (tests/test_kernels.py's criteria)."""
    M = card.rank8_matrices(np.random.default_rng(B), B, cuda)
    card.check_kernel("nullvec9", K.nullvec9_cuda(M), K.nullvec9_torch(M), M=M)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["rank 4", "zero", "scaled 1e-30", "scaled 1e30"])
def test_cuda_nullvec9_degenerate(cuda, case):
    """Pivots at the floor (rank 4, all zero) and matrices whose quotients
    leave the division's fast range (scaled): finite unit vectors."""
    r = np.random.default_rng(4)
    rank, scale = {"rank 4": (4, 1.0), "zero": (0, 1.0),
                   "scaled 1e-30": (8, 1e-30), "scaled 1e30": (8, 1e30)}[case]
    A = r.normal(0, 1, (33, 8, 9))
    A[:, rank:] = 0.0
    M = torch.tensor(np.einsum("bki,bkj->bij", A, A) * scale,
                     dtype=torch.float32, device=cuda)
    out = K.nullvec9_cuda(M)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.norm(dim=1), torch.ones(33, device=cuda),
                               rtol=0, atol=1e-3)


@pytest.mark.gpu
def test_cuda_nullvec9_unaligned_equals_aligned(cuda):
    """Operands 4 bytes off a 16-byte boundary take the word-by-word copies:
    the same bits as the aligned call."""
    A = torch.tensor(np.random.default_rng(7).normal(0, 1, (70, 8, 9)),
                     dtype=torch.float32, device=cuda)
    M = (A.transpose(1, 2) @ A).contiguous()
    buf = torch.empty(M.numel() + 1, device=cuda)
    off = buf[1:].view(M.shape)
    off.copy_(M)
    assert off.data_ptr() % 16 != 0
    assert torch.equal(K.nullvec9_cuda(off), K.nullvec9_cuda(M))


def _words(r, shape, dev):
    """Full-range uint32 words as int32 with the same bits."""
    w = r.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.tensor(w.view(np.int32), device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("ka,kb,sign", [
    *[pytest.param(ka, kb, False, id=f"{ka}-{kb}") for ka, kb in (
        (512, 512), (257, 131), (1, 33),
        # 8 tiles a warp with ragged edges
        (600, 600), (512, 501), (499, 1030))],
    pytest.param(257, 131, True, id="257-131-sign_bit")])
def test_cuda_hamming_matrix(cuda, ka, kb, sign):
    """Full-range words; half the rows equal (zero distances) and, with
    `sign`, the next as many apart in the sign bit alone."""
    r = np.random.default_rng(ka + kb)
    a, b = _words(r, (ka, 8), cuda), _words(r, (kb, 8), cuda)
    n = max(1, min(ka, kb) // 2)
    b[:n] = a[:n]                                        # zero distances
    if sign:
        b[n:2 * n] = a[:n] ^ torch.tensor(-2**31, dtype=torch.int32,
                                          device=cuda)
    out = K.hamming_matrix_cuda(a, b)
    assert torch.equal(out, K.hamming_matrix_torch(a, b))
    assert out.min().item() == 0.0 and out.max().item() > 100


@pytest.mark.gpu
@pytest.mark.parametrize("kb", [1, 33, 131, 512])
@pytest.mark.parametrize("w", [1, 7, 8, 64])
def test_cuda_hamming_matrix_widths(cuda, w, kb):
    """W = 8 (the compiled width, with float4 stores where Kb % 4 == 0 and a
    scalar edge otherwise) and the run-time widths: bit-exact."""
    r = np.random.default_rng(w * kb)
    a, b = _words(r, (67, w), cuda), _words(r, (kb, w), cuda)
    n = min(67, kb) // 2
    b[:n] = a[:n]
    assert torch.equal(K.hamming_matrix_cuda(a, b), K.hamming_matrix_torch(a, b))


@pytest.mark.gpu
def test_cuda_hamming_matrix_unaligned(cuda):
    """Descriptors 4 bytes off a 16-byte boundary take the run-time path."""
    r = np.random.default_rng(9)
    a, b = _words(r, (131, 8), cuda), _words(r, (64, 8), cuda)
    buf = torch.empty(a.numel() + 1, dtype=torch.int32, device=cuda)
    off = buf[1:].view(a.shape)
    off.copy_(a)
    assert off.data_ptr() % 16 != 0
    assert torch.equal(K.hamming_matrix_cuda(off, b), K.hamming_matrix_torch(a, b))


@pytest.mark.gpu
def test_cuda_dense_ties_take_the_first_index(cuda):
    """Kernel 5's matrix through the dense best/second on the card: equal
    distances take the first index, as jnp.argmin."""
    from rso_torch.kernels.stereo_fused import _best_second

    ta = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    tb = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    tb[:, 0] = torch.tensor([3, 1, 1, 1], dtype=torch.int32, device=cuda)
    best, d_best, second = _best_second(K.hamming_matrix_cuda(ta, tb))
    assert best.tolist() == [1, 1] and d_best.tolist() == second.tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("octave", [0, 1, 2])
@pytest.mark.parametrize("name", ["stereo_sad_fused", "stereo_sad_fused open",
                                  "track_sad_fused", "track_sad_fused open",
                                  "hamming_matrix", "sad_matrix"])
def test_cuda_kernels_on_the_bench_frames(cuda, bench, name, octave):
    """Kernels 2, 3, 5 and 6 on the bench frames' operands at each octave
    as the engine paths give them and chip_smoke.py times them
    (_torch_card.BenchInputs; kernels 2 and 3 also with the mask open): bit
    for bit the twin's.  The FAST_ORB descriptors also against the CPU's
    (a share of DESC_BIT_SHARE of their bits may flip), and kernel 5
    against torch.cdist(p=0) of the unpacked bits, its library call."""
    kernel = name.split()[0]
    args, kw = bench.operands(name, octave)
    out = getattr(K, f"{kernel}_cuda")(*args, **kw)
    card.check_kernel(kernel, out, getattr(K, f"{kernel}_torch")(*args, **kw),
                      name)
    if kernel == "hamming_matrix":
        from rso_torch.frontend.detect import detect_features

        img = build_pyramid(to_grayscale(torch.from_numpy(
            bench.seq.frames[0][0])), 3)[octave]
        cpu = detect_features(img, bench.desc_params, bench.Ks[octave],
                              bench.th.cpu(), True)
        assert torch.equal(cpu.valid, bench.descs[0][octave].valid.cpu())
        x = torch.bitwise_xor(cpu.desc, args[0].cpu())[cpu.valid]
        n_bits = int(K.hamming_matrix_torch(x, torch.zeros_like(x[:1])).sum())
        assert n_bits <= card.DESC_BIT_SHARE * 256 * int(cpu.valid.sum())
        shifts = torch.arange(32, dtype=torch.int32, device=cuda)
        bits = [((d[:, :, None] >> shifts) & 1).reshape(d.shape[0], -1).float()
                for d in args]
        assert torch.equal(torch.cdist(*bits, p=0), out)


@pytest.mark.gpu
@pytest.mark.parametrize("ka,kb", [(512, 512), (257, 131), (1, 33)])
def test_cuda_sad_matrix(cuda, ka, kb):
    r = np.random.default_rng(ka * kb)
    f = lambda k: torch.tensor(r.integers(0, 255 * 16, (k, 64)) / 16.0,  # noqa: E731
                               dtype=torch.float32, device=cuda)
    a, b = f(ka), f(kb)
    assert torch.equal(K.sad_matrix_cuda(a, b), K.sad_matrix_torch(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("ka,kb,p", [(1, 1, 64), (1, 257, 64), (257, 1, 64),
                                     (131, 257, 64), (131, 257, 63),
                                     (131, 257, 65), (40, 33, 128)])
def test_cuda_sad_matrix_ragged(cuda, ka, kb, p):
    """Partial 32x32 tiles on every edge, and widths that are not a multiple
    of the kernel's float4 steps: bit-exact with the twin."""
    r = np.random.default_rng(ka * kb + p)
    f = lambda k: torch.tensor(r.integers(0, 255 * 16, (k, p)) / 16.0,  # noqa: E731
                               dtype=torch.float32, device=cuda)
    a, b = f(ka), f(kb)
    assert torch.equal(K.sad_matrix_cuda(a, b), K.sad_matrix_torch(a, b))


@pytest.mark.gpu
def test_cuda_wrappers_count_launches_and_check_operands(cuda):
    reset_launches()
    img = torch.zeros((32, 48), device=cuda)
    K.corner_response_cuda(img, 20)
    assert K.LAUNCHES["corner_response"] == 1
    with pytest.raises(ValueError, match="dtype"):
        K.corner_response_cuda(img.double(), 20)
    with pytest.raises(ValueError, match="contiguous"):
        K.nullvec9_cuda(torch.zeros((9, 9, 4), device=cuda).permute(2, 0, 1))
    assert K.LAUNCHES["corner_response"] == 1 and K.LAUNCHES["nullvec9"] == 0
    d = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    K.hamming_matrix_cuda(d, d)
    with pytest.raises(ValueError, match="dtype"):
        K.hamming_matrix_cuda(d.float(), d.float())
    with pytest.raises(ValueError, match="row width"):
        K.sad_matrix_cuda(torch.zeros((4, 200), device=cuda),
                          torch.zeros((4, 200), device=cuda))
    assert K.LAUNCHES["hamming_matrix"] == 1 and K.LAUNCHES["sad_matrix"] == 0
    with pytest.raises(ValueError, match="win must be >= 1"):
        K.corner_response_cuda(img, 20, win=0)
    assert K.LAUNCHES["corner_response"] == 1
    K.corner_response_cuda(img, 20, win=46)
    assert K.LAUNCHES["corner_response"] == 1
    assert K.LAUNCHES["corner_response_wide"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_cuda_engine_modes_match_the_cpu(cuda, mode):
    """Each mode's engine on the card and on the CPU from the same frames:
    detection and stereo matching depend only on the images and are exact;
    tracked counts may differ by 2 (RANSAC runs as one kernel on the card,
    its null vectors kernel 4's routine, and as the plain path on the CPU,
    its null vectors from kernel 4's twin, another algorithm; the normal
    matrices sum in other orders: a track on the 1 px gate may fall either
    way)."""
    seq = make_sequence(n_frames=3, n_points=1800, H=160, W=240)
    cfg = mode_config(mode)
    gpu, cpu = Engine(cfg, seq.cam, device=cuda), Engine(cfg, seq.cam, device="cpu")
    reset_launches()
    for left, right in seq.frames:
        rg, rc = gpu.process_frame(left, right), cpu.process_frame(left, right)
        assert torch.equal(rg.detected_feats.cpu(), rc.detected_feats)
        assert torch.equal(rg.stereo_matches.cpu(), rc.stereo_matches)
        assert abs(int(rg.tracked_feats_from_last_frame)
                   - int(rc.tracked_feats_from_last_frame)) <= 2
    kernel = {"fast_orb_rbr_win": "hamming_matrix", "orb_bf_bf": "hamming_matrix",
              "sad_dense": "sad_matrix"}.get(mode, "stereo_sad_fused")
    assert K.LAUNCHES[kernel] > 0 and K.LAUNCHES["ransac"] > 0
    assert K.LAUNCHES["nullvec9"] == 0


def _two_frame_pyramids(dev):
    seq = make_sequence(n_frames=2, n_points=2000, H=376, W=1241)
    return [[build_pyramid(to_grayscale(torch.from_numpy(seq.frames[f][e])).to(dev), 3)
             for e in (0, 1)] for f in (0, 1)]


def _keypoints(img, k=512):
    from rso_torch.config import DetectParams
    from rso_torch.frontend.detect import detect_features

    return detect_features(img, DetectParams(), k,
                           torch.tensor(20, dtype=torch.int32, device=img.device),
                           False)


@pytest.mark.gpu
def test_cuda_set_last_equals_the_cpu(cuda):
    """_propagate's scatter on repeated targets: the last write wins on the
    card as on the CPU (a plain index_put_ promises no order on CUDA)."""
    from rso_torch.engine import _set_last

    r = np.random.default_rng(3)
    old = torch.tensor(r.normal(size=(512, 2)), dtype=torch.float32)
    vals = torch.tensor(r.normal(size=(512, 2)), dtype=torch.float32)
    tgt = torch.tensor(r.integers(0, 600, 512))       # repeats and drops
    new_c, w_c = _set_last(old, tgt, vals)
    new_g, w_g = _set_last(old.to(cuda), tgt.to(cuda), vals.to(cuda))
    assert torch.equal(new_g.cpu(), new_c) and torch.equal(w_g.cpu(), w_c)
    last = {}
    for i, t in enumerate(tgt.tolist()):
        last[t] = i
    for t, i in last.items():
        if t < 512:
            assert torch.equal(new_c[t], vals[i])


@pytest.mark.gpu
def test_cuda_lk_track_matches_the_cpu(cuda):
    """LK on the card and on the CPU: status equal; positions and residuals
    within 2e-3 px and 1e-3 (window sums in another order)."""
    from rso_torch.frontend.optical_flow import lk_track

    pyr = _two_frame_pyramids(cuda)
    f = _keypoints(pyr[0][0][0])
    g = lk_track(pyr[0][0], pyr[1][0], f.xy, f.valid)
    c = lk_track([p.cpu() for p in pyr[0][0]], [p.cpu() for p in pyr[1][0]],
                 f.xy.cpu(), f.valid.cpu())
    assert torch.equal(g.status.cpu(), c.status) and int(c.status.sum()) > 100
    torch.testing.assert_close(g.pos.cpu(), c.pos, atol=2e-3, rtol=0)
    torch.testing.assert_close(g.err.cpu(), c.err, atol=1e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("ssd_gate", [False, True])
def test_cuda_refine_positions_matches_the_cpu(cuda, ssd_gate):
    """The subpixel refine on the card and on the CPU: the same slots move,
    refined xy within 1e-3 px."""
    from rso_torch.frontend.refine import refine_positions

    pyr = _two_frame_pyramids(cuda)
    f = _keypoints(pyr[0][0][0])
    r = np.random.default_rng(4)
    xy = f.xy + torch.tensor(r.uniform(-1.5, 1.5, tuple(f.xy.shape)),
                             dtype=torch.float32, device=cuda)
    g = refine_positions(pyr[1][0][0], f.patch, xy, f.valid, ssd_gate=ssd_gate)
    c = refine_positions(pyr[1][0][0].cpu(), f.patch.cpu(), xy.cpu(),
                         f.valid.cpu(), ssd_gate=ssd_gate)
    assert torch.equal((g != xy).any(1).cpu(), (c != xy.cpu()).any(1))
    torch.testing.assert_close(g.cpu(), c, atol=1e-3, rtol=0)


BA_CAM = StereoCamera.make(fx_l=500.0, fy_l=500.0, cx_l=320.0, cy_l=240.0,
                           baseline=0.5)


def _ba_problem(seed, P=8, L=256, noise=0.2):
    """tests/test_ba.py's make_ba_problem without jax: a forward-walking
    window, landmarks 5-30 m deep, observations with `noise` px, poses
    perturbed by 1 cm and landmarks by 20 cm; on the CPU."""
    from scipy.spatial.transform import Rotation

    from rso_torch.ba.ba import BAProblem, _project_grid

    r = np.random.default_rng(seed)
    poses = []
    for p in range(P):
        Rwc = Rotation.from_rotvec([0.0, 0.002 * p, 0.0]).as_matrix().T
        t = -Rwc @ np.array([0.01 * p, -0.005 * p, 0.4 * p])
        poses.append(np.concatenate([Rotation.from_matrix(Rwc).as_rotvec(), t]))
    poses = torch.tensor(np.stack(poses), dtype=torch.float32)
    lmks = torch.tensor(np.stack([r.uniform(-8, 8, L), r.uniform(-4, 4, L),
                                  r.uniform(5, 30, L)], -1), dtype=torch.float32)
    pix = _project_grid(BA_CAM, poses, lmks)[0]
    obs = pix + torch.tensor(r.normal(0, noise, tuple(pix.shape)),
                             dtype=torch.float32)
    poses0 = poses + torch.tensor(r.normal(0, 0.01, (P, 6)), dtype=torch.float32)
    poses0[0] = poses[0]
    lmks0 = lmks + torch.tensor(r.normal(0, 0.2, (L, 3)), dtype=torch.float32)
    return BAProblem(poses0, lmks0, obs, torch.ones((P, L), dtype=torch.bool))


BA_CASES = {"robust": {}, "least_squares": {"use_robust": False},
            "odometry_prior": {"rel_meas": np.zeros((7, 6), np.float32),
                               "rel_w_rot": 4e2, "rel_w_trans": 25.0},
            "tol0": {"tol": 0.0}}


@pytest.mark.gpu
@pytest.mark.parametrize("case", BA_CASES)
def test_cuda_bundle_adjust_matches_the_cpu(cuda, case):
    """bundle_adjust on the card and on the CPU from the same problem, held
    as chip_smoke.py holds them (its BA_* bounds: the CPU tests' tolerances,
    n_iters equal or parted at the f32 noise floor of the cost)."""
    from rso_torch.ba import bundle_adjust

    prob = _ba_problem(11)
    gprob = card.problem_to(prob, cuda)
    gcam = BA_CAM.to(cuda)
    kw = dict(BA_CASES[case], max_iters=20)
    g = bundle_adjust(gcam, gprob, **kw)
    assert g.poses.device.type == "cuda"
    c = bundle_adjust(BA_CAM, prob, **kw)
    card.same_solve(case, g, c,
                    lambda k: bundle_adjust(gcam, gprob, **dict(kw, max_iters=k)),
                    lambda k: bundle_adjust(BA_CAM, prob, **dict(kw, max_iters=k)),
                    lambda p, l: bundle_adjust(BA_CAM, prob._replace(
                        poses=p, lmks=l), **dict(kw, max_iters=0)).cost)


@pytest.mark.gpu
def test_cuda_bench_ba_problem(cuda):
    """The bench's P = 8, L = 1024 problem (chip_smoke.py phase 9a)."""
    from rso_torch.ba import bundle_adjust

    seq_cam = card.bench_cam()
    gcam = seq_cam.to(cuda)
    gprob = card.bench_ba_problem(gcam, cuda)
    prob = card.problem_to(gprob, torch.device("cpu"))
    g = bundle_adjust(gcam, gprob, max_iters=15)
    c = bundle_adjust(seq_cam, prob, max_iters=15)
    card.same_solve("bench", g, c,
                    lambda k: bundle_adjust(gcam, gprob, max_iters=k),
                    lambda k: bundle_adjust(seq_cam, prob, max_iters=k),
                    lambda p, l: bundle_adjust(seq_cam, prob._replace(
                        poses=p, lmks=l), max_iters=0).cost)
    assert torch.isfinite(g.poses).all() and float(g.cost) < 1e-3


@pytest.mark.gpu
def test_cuda_window_solve_matches_the_cpu(cuda):
    """Three windows as one batch on the card against the same batch on the
    CPU, window by window (one noiseless; they stop at different
    iterations: the batch freezes each one's carry)."""
    from rso_torch.ba import window_sharded_bundle_adjust

    probs = [_ba_problem(21), _ba_problem(22), _ba_problem(23, noise=0.0)]
    gprobs = [card.problem_to(p, cuda) for p in probs]
    gcam = BA_CAM.to(cuda)

    def solve(cam, ps, k=15):
        return window_sharded_bundle_adjust(cam, ps, max_iters=k)

    g, c = solve(gcam, gprobs), solve(BA_CAM, probs)
    for w in range(3):
        assert g[w].poses.device.type == "cuda"
        card.same_solve(f"window {w}", g[w], c[w],
                        lambda k: solve(gcam, gprobs, k)[w],
                        lambda k: solve(BA_CAM, probs, k)[w],
                        lambda p, l: solve(BA_CAM, [probs[w]._replace(
                            poses=p, lmks=l)], 0)[0].cost)


# ---- the compiled BA solve: CUDA graphs against the eager LM loop -----------

def _marg_prior(poses, seed):
    """A float64 PSD marginalization prior over the window (H [P,6,P,6],
    b [P,6], lin [P,6]), as SlidingWindow.prior_terms lays it out."""
    r = np.random.default_rng(seed)
    P = poses.shape[0]
    A = r.normal(0, 10.0, (P * 6, P * 6))
    H = A @ A.T / (P * 6) + 100.0 * np.eye(P * 6)
    lin = poses.cpu().numpy().astype(np.float64) + r.normal(0, 1e-3, (P, 6))
    return H.reshape(P, 6, P, 6), r.normal(0, 1.0, (P, 6)), lin


def _graph_cases(dev):
    """name -> (camera, BAProblem on dev, bundle_adjust keyword arguments):
    the bench problem at tol 0 and 1e-5, and a VOWithBA-shaped window (P =
    5, 1024 landmark slots, 2-view weights) with both priors."""
    bench_cam = card.bench_cam().to(dev)
    bench = card.bench_ba_problem(bench_cam, dev)
    win = card.problem_to(_ba_problem(31, P=5, L=1024), dev)
    win = win._replace(lmk_weight=torch.where(
        torch.arange(1024, device=dev) % 3 == 0, 0.2, 1.0))
    rel = np.random.default_rng(32).normal(0, 1e-3, (4, 6)).astype(np.float32)
    both = dict(rel_meas=rel, rel_w_rot=4e2, rel_w_trans=25.0,
                marg_prior=_marg_prior(win.poses, 33), max_iters=15)
    return {"bench_tol0": (bench_cam, bench, {"max_iters": 25, "tol": 0.0}),
            "bench_tol1e-5": (bench_cam, bench, {"max_iters": 15}),
            "window_both_priors": (BA_CAM.to(dev), win, both)}


@pytest.mark.gpu
def test_cuda_graph_ba_equals_the_eager_loop(cuda, monkeypatch):
    """bundle_adjust's graphs (the first call: the warm-up's answer, with
    the eager loop's flag reads; then one graph launch with none) against
    levenberg_marquardt's eager loop, bit for bit; each case replayed again
    after the others (other shapes and keys in between)."""
    import rso_torch.ba.ba as B
    from rso_torch.ba import bundle_adjust
    from rso_torch.graphs import GRAPH_LAUNCHES
    from rso_torch.solver.robust_gn import HOST_READS

    monkeypatch.setattr(B, "_SOLVES", {})   # no solve captured before
    cases = _graph_cases(cuda)
    want = {}
    for name, (cam, prob, kw) in cases.items():
        HOST_READS.clear()
        want[name] = card.eager_ba(cam, prob, **kw)
        reads = HOST_READS["lm"]
        for call in ("warm-up", "replay"):
            HOST_READS.clear()
            GRAPH_LAUNCHES.clear()
            card.same_bits(f"{name} {call}", bundle_adjust(cam, prob, **kw),
                           want[name])
            # the warm-up is the eager loop; a replay is one graph launch
            # whose LM loop reads nothing back
            assert HOST_READS["lm"] == (reads if call == "warm-up" else 0), (
                name, call)
            assert GRAPH_LAUNCHES["lm"] == (call == "replay"), (name, call)
    for name, (cam, prob, kw) in cases.items():
        card.same_bits(f"{name} after the other cases",
                       bundle_adjust(cam, prob, **kw), want[name])


@pytest.mark.gpu
@pytest.mark.parametrize("prior", [False, True])
def test_cuda_graph_window_batch_equals_the_eager_loop(cuda, prior):
    """Three windows as one batch (window_sharded_bundle_adjust, mesh=None)
    in graphs against the eager loop on the stacked problem, window by
    window bit for bit, twice; plain at tol 1e-4 (the windows stop at
    different iterations: at 1e-5 the card runs all three to max_iters)
    and with the odometry prior."""
    from rso_torch.ba import window_sharded_bundle_adjust
    from rso_torch.ba.window_sharded import stack_problems

    probs = [card.problem_to(_ba_problem(s, noise=n), cuda)
             for s, n in ((21, 0.2), (22, 0.2), (23, 0.0))]
    rel = [np.random.default_rng(s).normal(0, 1e-3, (7, 6)).astype(np.float32)
           for s in range(3)]
    kw = (dict(max_iters=15, rel_w_rot=4e2, rel_w_trans=25.0) if prior
          else dict(max_iters=15, tol=1e-4))
    want = card.eager_ba(BA_CAM, stack_problems(probs),
                         rel_meas=np.stack(rel), **kw)
    if not prior:
        assert len(set(want.n_iters.tolist())) > 1, want.n_iters
    for call in ("warm-up", "replay"):
        got = window_sharded_bundle_adjust(BA_CAM.to(cuda), probs,
                                           rel_meas=rel, **kw)
        for w in range(3):
            card.same_bits(f"window {w} {call}", got[w],
                           type(want)(*(t[w] for t in want)))


@pytest.mark.gpu
@pytest.mark.parametrize("changed", ["tol", "kernel_param", "max_iters"])
def test_cuda_graph_ba_a_changed_scalar_gets_its_own_graphs(cuda, changed):
    """The stale-graph guard on the card: calls on one problem that differ
    in one Python scalar the graphs bake in, in turns; every replay equals
    its own eager answer."""
    from rso_torch.ba import bundle_adjust

    cam = BA_CAM.to(cuda)
    prob = card.problem_to(_ba_problem(41), cuda)
    other = {"tol": {"tol": 1e-2}, "kernel_param": {"kernel_param": 1.0},
             "max_iters": {"max_iters": 2}}[changed]
    kws = [{"max_iters": 15}, dict({"max_iters": 15}, **other)]
    want = [card.eager_ba(cam, prob, **kw) for kw in kws]
    assert not torch.equal(want[0].poses, want[1].poses)
    for turn in range(3):
        for kw, w in zip(kws, want):
            card.same_bits(f"{kw} {turn}", bundle_adjust(cam, prob, **kw), w)


# ---- the mesh forms' solve on one NCCL rank: graphs holding the all_reduces -


@pytest.fixture
def nccl(cuda):
    """A one-rank NCCL group (rso_torch.mesh.ensure_group), destroyed
    afterwards if it was made here."""
    import torch.distributed as dist

    from rso_torch.mesh import ensure_group

    made = not dist.is_initialized()
    ensure_group("cuda")
    assert dist.get_backend() == "nccl"
    yield cuda
    if made:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_cuda_graph_mesh_ba_equals_the_eager_mesh_loop(nccl, monkeypatch):
    """distributed_bundle_adjust on a one-rank NCCL mesh as a compiled
    solve (its all_reduces and landmark gather inside the graph) against
    the eager mesh loop (chip_smoke.eager_mesh_solves) and bundle_adjust,
    bit for bit, at the warm-up and at a replay; a replay is one graph
    launch with no LM host read, and counts the all_reduces the eager loop
    makes: one before the loop, two an iteration it ran (whole blocks),
    one gather."""
    import rso_torch.ba.ba as B
    from rso_torch.ba import bundle_adjust, distributed_bundle_adjust, make_mesh

    monkeypatch.setattr(B, "_SOLVES", {})
    mesh = make_mesh()
    for name, (cam, prob, kw) in _graph_cases(nccl).items():
        kw = {k: v for k, v in kw.items() if k != "marg_prior"}
        with card.eager_mesh_solves():
            want = distributed_bundle_adjust(cam, prob, mesh, **kw)
        card.same_bits(f"{name} bundle_adjust", bundle_adjust(cam, prob, **kw), want)
        for call in ("warm-up", "replay"):
            got, counts = card.counted_solve(
                lambda: distributed_bundle_adjust(cam, prob, mesh, **kw))
            card.same_bits(f"{name} {call}", got, want)
            if call == "replay":
                n = card.lm_loop_iterations(int(got.n_iters), kw["max_iters"])
                assert (counts["graph_launches"], counts["lm_reads"]) == (
                    1, 0), name
                assert counts["collectives"] == {
                    "solve lmk": 1 + 2 * n, "gather lmk": 1}, (name, counts)


@pytest.mark.gpu
def test_cuda_graph_ba_block_form_equals_the_eager_loop(nccl, monkeypatch):
    """The block form (rso_torch.graphs._Blocks: a graph launch a segment
    and a block, a flag read a block), which a solve takes where its block
    holds nodes no conditional body takes (NCCL's across ranks), forced
    here by emptying graphs._BODY_TYPES: bundle_adjust and the one-rank
    mesh solve equal the eager loop bit for bit at the first call and at a
    replay, which makes the eager loop's flag reads, 2 + (blocks run)
    graph launches and the eager loop's all_reduces."""
    import rso_torch.ba.ba as B
    import rso_torch.graphs as graphs
    from rso_torch.ba import bundle_adjust, distributed_bundle_adjust, make_mesh
    from rso_torch.solver.robust_gn import HOST_READS

    monkeypatch.setattr(B, "_SOLVES", {})
    monkeypatch.setattr(graphs, "_BODY_TYPES", frozenset())
    mesh = make_mesh()
    cam, prob, kw = _graph_cases(nccl)["bench_tol1e-5"]

    def eager_mesh():
        with card.eager_mesh_solves():
            return distributed_bundle_adjust(cam, prob, mesh, **kw)

    solves = {"bundle_adjust": (lambda: card.eager_ba(cam, prob, **kw),
                                lambda: bundle_adjust(cam, prob, **kw)),
              "mesh": (eager_mesh,
                       lambda: distributed_bundle_adjust(cam, prob, mesh,
                                                         **kw))}
    for name, (eager, compiled) in solves.items():
        HOST_READS.clear()
        want = eager()
        reads = HOST_READS["lm"]
        for call in ("warm-up", "replay"):
            got, counts = card.counted_solve(compiled)
            card.same_bits(f"{name} {call}", got, want)
        n = card.lm_loop_iterations(int(got.n_iters), kw["max_iters"])
        assert (counts["graph_launches"], counts["lm_reads"]) == (
            2 + n // B.LM_BLOCK, reads), (name, counts)
        if name == "mesh":
            assert counts["collectives"] == {"solve lmk": 1 + 2 * n,
                                             "gather lmk": 1}, counts
    assert {type(v.composed).__name__ for s in B._SOLVES.values()
            for v in s._variants.values()} == {"_Blocks"}


@pytest.mark.gpu
def test_cuda_graph_one_rank_win_mesh_equals_the_batch(nccl):
    """Three windows on a (1,1) ('win','lmk') NCCL mesh as a compiled
    solve against the one-device batch, window by window bit for bit, at
    the warm-up and at a replay (one graph launch, no LM host read); the
    'win' gather follows the graph."""
    from rso_torch.ba import make_win_mesh, window_sharded_bundle_adjust

    probs = [card.problem_to(_ba_problem(s, noise=n), nccl)
             for s, n in ((21, 0.2), (22, 0.2), (23, 0.0))]
    cam = BA_CAM.to(nccl)
    kw = dict(max_iters=15, tol=1e-4)
    want = window_sharded_bundle_adjust(cam, probs, **kw)
    mesh = make_win_mesh(1, 1)
    for call in ("warm-up", "replay"):
        got, counts = card.counted_solve(
            lambda: window_sharded_bundle_adjust(cam, probs, mesh, **kw))
        for w in range(3):
            card.same_bits(f"window {w} {call}", got[w], want[w])
        if call == "replay":
            n = card.lm_loop_iterations(max(int(g.n_iters) for g in got), 15)
            assert (counts["graph_launches"], counts["lm_reads"]) == (1, 0)
            assert counts["collectives"] == {
                "solve lmk": 1 + 2 * n, "gather lmk": 1, "gather win": 1}, (
                counts)


# ---- the compiled step: CUDA graphs against the eager step ------------------

def _eager_run(cfg, cam, frames, hw, dev):
    """The plain make_step loop from init_state: results and the launches
    of each frame."""
    from rso_torch.engine import init_state, make_step

    step = make_step(cfg, cam, *hw)
    st = init_state(cfg, hw, dev)
    out = []
    for left, right in frames:
        reset_launches()
        st, res = step(st, left, right)
        out.append((res, dict(settle_launches())))
    return out


def _path_config(path):
    import dataclasses

    from rso_torch.config import load_config
    from rso_torch.synthetic import synthetic_config

    rep = dataclasses.replace
    cfg = synthetic_config()
    if path == "kitti":
        return load_config(str(card.REPO / "configs" / "kitti.ini"))
    if path == "descriptor":
        return mode_config("fast_orb_rbr_win", upright=False)
    return cfg.replace(**{
        "default": {},
        "every": {"tpu": rep(cfg.tpu, detect_every=3)},
        "flow": {"if_match": rep(cfg.if_match, ifm_method=3)},
        "eigh_lm": {"least_squares": rep(cfg.least_squares,
                                         solve_backend="eigh", use_lm=True)},
    }[path])


@pytest.mark.gpu
@pytest.mark.parametrize("every", [1, 3, "kitti", "descriptor", "flow"])
def test_cuda_graphs_equal_the_eager_step(cuda, every):
    """Engine's composed CUDA graph against the eager step on the bench
    scene: every field of every frame bit for bit and the same launches a
    frame, frame by frame (detect_every 3: both IF bodies) and as one
    chunk, each frame after the first one graph launch with no host read."""
    from rso_torch.graphs import GRAPH_LAUNCHES
    from rso_torch.solver.robust_gn import HOST_READS

    cfg = _path_config({1: "default", 3: "every"}.get(every, every))
    seq = make_sequence(n_frames=7, n_points=2000, H=376, W=1241)
    frames = [(torch.from_numpy(l).to(cuda), torch.from_numpy(r).to(cuda))
              for l, r in seq.frames]
    eng = Engine(cfg, seq.cam, device=cuda)
    eager = _eager_run(cfg, eng.cam, frames, (376, 1241), cuda)
    for left, right in frames:            # captures every graph set
        eng.process_frame(left, right)
    n_graphs = eng._get_step(376, 1241).n_graphs
    assert n_graphs >= (11 if every == 3 else 5)
    assert eng._get_step(376, 1241).n_composed == 1
    eng.reset()
    for i, (left, right) in enumerate(frames):
        reset_launches()
        HOST_READS.clear()
        GRAPH_LAUNCHES.clear()
        got = eng.process_frame(left, right)
        card.same_bits(f"frame {i}", got, eager[i][0])
        assert dict(settle_launches()) == eager[i][1], f"frame {i} launches"
        assert sum(HOST_READS.values()) == 0, dict(HOST_READS)
        assert dict(GRAPH_LAUNCHES) == {"step": 1}
    eng.reset()
    chunk = eng.process_chunk([f[0] for f in frames], [f[1] for f in frames])
    for i, (want, _) in enumerate(eager):
        card.same_bits(f"chunk frame {i}", StepResultAt(chunk, i), want)
    assert eng._get_step(376, 1241).n_graphs == n_graphs


def StepResultAt(stacked, i):
    return type(stacked)(*(t[i] for t in stacked))


@pytest.mark.gpu
def test_cuda_graph_capture_raises_on_a_host_read(cuda):
    """A host read inside the step fails the capture, which raises; the
    warm-up before it ran eagerly and the stream is usable afterwards."""
    from rso_torch.graphs import CompiledStep

    def step(state, x, *, loop):
        y = x * 2.0
        if bool(y.sum() > 0):             # a host read
            y = y + 1.0
        return state + 1.0, y

    cs = CompiledStep(step)
    state = torch.zeros(3, device=cuda)
    x = torch.ones(3, device=cuda)
    with pytest.raises(RuntimeError):
        cs(state, x)
    assert cs.n_graphs == 0
    assert torch.equal((x + 1.0).cpu(), torch.full((3,), 2.0))


@pytest.mark.gpu
def test_cuda_eigh_backend_runs_the_eager_step(cuda):
    """The eigh backend's eigensolver on the card is eigh6's routine inside
    the GN iteration kernel (csrc/eigh6.cuh in csrc/gn_iter.cu), which
    reads nothing back, so Engine captures that step too: its graph gives
    the eager step's results bit for bit, one graph launch a frame with no
    host read, the GN kernel launched in the GN loops as often as
    eagerly."""
    from rso_torch.graphs import GRAPH_LAUNCHES
    from rso_torch.solver.robust_gn import HOST_READS

    cfg = _path_config("eigh_lm")
    seq = make_sequence(n_frames=4, n_points=2000, H=376, W=1241)
    frames = [(torch.from_numpy(l).to(cuda), torch.from_numpy(r).to(cuda))
              for l, r in seq.frames]
    eng = Engine(cfg, seq.cam, device=cuda)
    eager = _eager_run(cfg, eng.cam, frames, (376, 1241), cuda)
    assert all(launches["gn_iter"] > 0 and "eigh6" not in launches
               for _, launches in eager[1:])
    for i, (left, right) in enumerate(frames):
        reset_launches()
        HOST_READS.clear()
        GRAPH_LAUNCHES.clear()
        card.same_bits(f"frame {i}", eng.process_frame(left, right), eager[i][0])
        if i > 0:
            assert dict(settle_launches()) == eager[i][1], f"frame {i} launches"
            assert sum(HOST_READS.values()) == 0 and dict(GRAPH_LAUNCHES) == {
                "step": 1}
    step = eng._get_step(376, 1241)
    assert step.capture and step.n_graphs == 5 and step.n_composed == 1


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 11, 4096])
@pytest.mark.parametrize("cond", [10.0, 1e3, 1e7, 0])
def test_cuda_eigh6(cuda, B, cond):
    """eigh6's routine (the twin, the plain GN iteration's eigensolver on
    the card; the gn_iter kernel runs the same routine) against
    torch.linalg.eigh (cuSOLVER) on the card: eigenvalues within 1e-5 of
    |w[5]|, w[0] within _torch_card.EIGH6_W0_RTOL cond + 1e-5 relative
    where cond <= 1e5, and the GN step V diag(1/w) V^T g of both within
    1e-6 cond + 1e-5 relative where cond <= 1e3 (an f32 solve's
    perturbation grows with the condition number; 4096 matrices at cond
    1e3 reached 3e-4; beyond 1e3 both solve an ill-posed system)."""
    from rso_torch.kernels.eigh6 import eigh6_torch

    rng = np.random.default_rng(B + int(cond))
    H = card.gn_normal_matrices(rng, B, cond, cuda)
    w, V = eigh6_torch(H)
    scale = w.abs().amax(-1, keepdim=True)
    lw, lV = torch.linalg.eigh(H)
    assert ((w - lw).abs() <= 1e-5 * scale).all()
    if 0 < cond <= 1e5:
        rel0 = (w[..., 0] - lw[..., 0]).abs() / lw[..., 0].abs()
        assert rel0.max() <= card.EIGH6_W0_RTOL * cond + 1e-5, rel0.max()
    if 0 < cond <= 1e3:
        g = torch.tensor(rng.standard_normal((B, 6)), dtype=torch.float32,
                         device=cuda)
        def step(w, V):
            return (V @ ((V.mT @ g[..., None]) / w[..., None]))[..., 0]

        want = step(lw, lV)
        got = step(w, V)
        rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
        assert rel.max() <= 1e-6 * cond + 1e-5, rel.max()


def _gn_inputs(seed, dev, n=300):
    """Stereo correspondences of a random cloud under a small motion, with
    outliers: (camera, prev_obs, cur_obs, mask)."""
    from rso_torch.geometry.stereo_camera import project_stereo

    cam = BA_CAM.to(dev)
    r = np.random.default_rng(seed)
    pts = np.stack([r.uniform(-8, 8, n), r.uniform(-2, 2, n),
                    r.uniform(4, 40, n)], -1).astype(np.float32)
    pose = np.array([0.01, -0.02, 0.005, 0.1, -0.05, 0.4], np.float32)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    prev = project_stereo(cam, f(pts), torch.zeros(6, device=dev))
    cur = project_stereo(cam, f(pts), f(pose))
    cur = cur + f(r.normal(0, 0.3, cur.shape))
    bad = r.random(n) < 0.15
    cur[f(bad).bool()] += 25.0
    return cam, prev, cur, torch.from_numpy(r.random(n) > 0.05).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("gn_block", [1, 2, 4])
@pytest.mark.parametrize("backend", ["chol", "eigh_lm"])
def test_cuda_composed_gn_loops_equal_the_eager_loops(cuda, gn_block,
                                                      backend, monkeypatch):
    """solve_pose as a CompiledStep (two GN loops as WHILE nodes) against
    the eager blocks on several inputs of one shape: bit for bit, the
    eager loop's launches, no host read and one graph launch a solve."""
    import dataclasses

    import rso_torch.solver.robust_gn as G
    from rso_torch.config import LeastSquaresParams
    from rso_torch.graphs import GRAPH_LAUNCHES, CompiledStep

    monkeypatch.setattr(G, "GN_BLOCK", gn_block)
    ls = LeastSquaresParams()
    if backend == "eigh_lm":
        ls = dataclasses.replace(ls, solve_backend="eigh", use_lm=True)

    def fn(_state, cam, prev, cur, mask, *, loop):
        return None, G.solve_pose(cam, prev, cur, mask, ls, loop=loop)

    cs = CompiledStep(fn)
    for seed in range(4):
        args = _gn_inputs(seed, cuda)
        reset_launches()
        want = G.solve_pose(*args, ls)
        want_launches = dict(settle_launches())
        reset_launches()
        G.HOST_READS.clear()
        GRAPH_LAUNCHES.clear()
        got = cs(None, *args)[1]
        card.same_bits(f"seed {seed}", got, want)
        assert dict(settle_launches()) == want_launches, seed
        if seed > 0:
            assert sum(G.HOST_READS.values()) == 0
            assert dict(GRAPH_LAUNCHES) == {"step": 1}
    assert cs.n_composed == 1


@pytest.mark.gpu
def test_cuda_composed_branches_follow_the_device_predicate(cuda):
    """A step with two branches as IF nodes: each frame takes the branch
    the predicate computes on the device from the state, equal to the
    eager step, the branches' launches counted where they ran."""
    from rso_torch.graphs import Branches, CompiledStep

    M = card.rank8_matrices(np.random.default_rng(9), 2, cuda)

    def fn(state, x, *, loop, do_detect):
        if do_detect:
            return state + 1, x + K.nullvec9_cuda(M).sum()
        return state + 2, x * 2.0

    def flags(state):
        f = state % 3 == 0
        return torch.stack([f, ~f])

    branches = Branches(keys=(True, False), read=lambda st: bool(st % 3 == 0),
                        flags=flags)
    cs = CompiledStep(fn, branches=branches)
    plain = CompiledStep(fn, branches=branches, capture=False)
    x = torch.ones(4, device=cuda)
    state, _ = cs(torch.zeros((), dtype=torch.int32, device=cuda), x)
    pstate, _ = plain(torch.zeros((), dtype=torch.int32, device=cuda), x)
    reset_launches()
    detects, launches = 0, collections.Counter()
    for _ in range(6):                    # states 1, 3, 4, 6, 7, 9
        detects += int(pstate) % 3 == 0
        reset_launches()
        state, out = cs(state, x)
        launches.update(settle_launches())
        pstate, want = plain(pstate, x)
        assert torch.equal(state, pstate) and torch.equal(out, want)
    assert dict(launches) == {"nullvec9": detects} and detects == 3
    reset_launches()
    for _ in range(3):                    # states 10, 12, 13
        state, _ = cs(state, x)
    assert cs.taken() == {True: 1, False: 2}


# ---- the batched kernels and the batched step (rso_torch.parallel) --------

def _one_launch(name, fn):
    """fn() under a fresh launch count: it launched `name` once."""
    reset_launches()
    out = fn()
    assert dict(settle_launches()) == {name: 1}, dict(settle_launches())
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("win", [4, 7, 46])
def test_cuda_batched_corner_response(cuda, win):
    """vmap over three octave-sized images with a threshold each: one
    launch (the one-tile path at win 4 and 7, the wide path at 46, counted
    under its name), each lane bit for bit the twin's."""
    seq = make_sequence(n_frames=3, n_points=2000, H=376, W=1241)
    imgs = torch.stack([to_grayscale(torch.from_numpy(l)) for l, _ in
                        seq.frames]).to(cuda)
    th = torch.tensor([10, 20, 25], dtype=torch.int32, device=cuda)
    name = "corner_response" if win <= 45 else "corner_response_wide"
    out = _one_launch(name, lambda: torch.func.vmap(
        lambda i, t: K.corner_response_cuda(i, t, win=win))(imgs, th))
    card.check_lanes(name, out, lambda b: K.corner_response_torch(
        imgs[b], th[b], win=win), 3)


@pytest.mark.gpu
def test_cuda_batched_stereo_and_track_sad_fused(cuda):
    """Kernels 2 and 3 under vmap over three lanes (their own slot sets):
    one launch each, every lane bit for bit the twin's."""
    lanes = [_stereo_case(257, seed, cuda) for seed in range(3)]
    stacked = [torch.stack(x) for x in zip(*lanes)]
    kw = dict(max_y_diff=2.0, max_disp=60.0, max_distance=1e4)
    out = _one_launch("stereo_sad_fused", lambda: torch.func.vmap(
        lambda *a: K.stereo_sad_fused_cuda(*a, **kw))(*stacked))
    card.check_lanes("stereo_sad_fused", out,
                     lambda b: K.stereo_sad_fused_torch(*lanes[b], **kw), 3)
    pl, pr, xl, xr, okl, okr = stacked
    tr = (pl, pr, pr, pl, xl, xr, xl[..., 0], xr[..., 0], okl, okr)
    kw = dict(win_row=20.0, win_col=30.0, sad_max=1e4)
    out = _one_launch("track_sad_fused", lambda: torch.func.vmap(
        lambda *a: K.track_sad_fused_cuda(*a, **kw))(*tr))
    card.check_lanes("track_sad_fused", out, lambda b: K.track_sad_fused_torch(
        *(t[b] for t in tr), **kw), 3)


@pytest.mark.gpu
def test_cuda_batched_nullvec9(cuda):
    """Kernel 4's vmap rule folds the lanes into its batch: one launch,
    each lane the unbatched kernel's bits and held to the twin by its card
    check."""
    rng = np.random.default_rng(5)
    M = torch.stack([card.rank8_matrices(rng, 256, cuda) for _ in range(3)])
    out = _one_launch("nullvec9", lambda: torch.func.vmap(K.nullvec9_cuda)(M))
    card.check_lanes("nullvec9", out, lambda b: K.nullvec9_cuda(M[b]), 3, M)


@pytest.mark.gpu
def test_cuda_batched_hamming_and_sad_matrices(cuda):
    """Kernels 5 and 6 under vmap over three lanes: one launch each, bit
    for bit the twins'."""
    g = torch.Generator().manual_seed(9)
    d = torch.randint(-2 ** 31, 2 ** 31 - 1, (3, 300, 8), generator=g,
                      dtype=torch.int64).to(torch.int32).to(cuda)
    out = _one_launch("hamming_matrix", lambda: torch.func.vmap(
        K.hamming_matrix_cuda)(d, d.flip(1)))
    card.check_lanes("hamming_matrix", out, lambda b: K.hamming_matrix_torch(
        d[b], d[b].flip(0)), 3)
    p = (torch.randint(0, 256 * 16, (3, 257, 64), generator=g) / 16.0).to(cuda)
    q = p.roll(1, dims=1)
    out = _one_launch("sad_matrix", lambda: torch.func.vmap(
        K.sad_matrix_cuda)(p, q))
    card.check_lanes("sad_matrix", out,
                     lambda b: K.sad_matrix_torch(p[b], q[b]), 3)


@pytest.mark.gpu
@pytest.mark.parametrize("name", card.BenchLanes.NAMES)
def test_cuda_batched_kernels_on_the_bench_lanes(bench_lanes, name):
    """Each kernel under vmap over 11 lanes of the bench scene, as the
    batched step launches it and chip_smoke.py times it
    (_torch_card.BenchLanes): one launch for every lane, each lane bit for
    bit the twin's (kernel 4 and LK: the unbatched kernel's, kernel 4 also
    held to the twin by its card check)."""
    run, lane = bench_lanes.calls[name]
    card.check_lanes(name, _one_launch(name, run), lane, bench_lanes.B,
                     bench_lanes.M)


@pytest.mark.gpu
def test_cuda_batch_engine_lanes_equal_lone_engines(cuda):
    """BatchEngine(B = 3) on the bench size: CUDA graphs replayed, 6/3/3/1
    launches a frame for all lanes (kernels 1-3, RANSAC) and one GN kernel
    launch a GN block,
    each lane's integer fields equal to an
    Engine's alone, its floats within the batch bounds (the batched GN
    sums: tests/test_torch_batch.py), and process_chunk equal to
    process_frames bit for bit."""
    from rso_torch.parallel import BatchEngine
    from rso_torch.synthetic import synthetic_config

    cfg = synthetic_config()
    seqs = [make_sequence(n_frames=5, n_points=2000, H=376, W=1241, seed=s)
            for s in range(3)]
    lefts = torch.stack([torch.stack([torch.from_numpy(l) for l, _ in
                                      s.frames]) for s in seqs]).to(cuda)
    rights = torch.stack([torch.stack([torch.from_numpy(r) for _, r in
                                       s.frames]) for s in seqs]).to(cuda)
    be = BatchEngine(cfg, seqs[0].cam, batch=3, img_h=376, img_w=1241,
                     device=cuda)
    be.process_frames(lefts[:, 0], rights[:, 0])        # warm-up, capture
    n_graphs = be._step.n_graphs
    assert n_graphs == 5
    be = BatchEngine(cfg, seqs[0].cam, batch=3, img_h=376, img_w=1241,
                     device=cuda)
    reset_launches()
    frames = [be.process_frames(lefts[:, n], rights[:, n]) for n in range(5)]
    # the GN kernel: one launch a block for all lanes, the loops running to
    # the slowest lane (GN_BLOCK 1)
    gn = sum(int(f.num_it.max()) + int(f.num_it_final.max()) for f in frames)
    assert dict(settle_launches()) == {"corner_response": 30, "stereo_sad_fused": 15,
                                "track_sad_fused": 15, "ransac": 5,
                                "gn_iter": gn}
    for b, s in enumerate(seqs):
        eng = Engine(cfg, s.cam, device=cuda)
        for n in range(5):
            alone = eng.process_frame(lefts[b, n], rights[b, n])
            for field, x, y in zip(alone._fields, alone, frames[n]):
                what = f"lane {b} frame {n} {field}"
                if not x.dtype.is_floating_point:
                    assert torch.equal(x, y[b]), what
                else:
                    atol = 5e-3 if field in ("residuals", "cost") else 1e-5
                    torch.testing.assert_close(y[b], x, atol=atol, rtol=0,
                                               msg=what)
    chunk = BatchEngine(cfg, seqs[0].cam, batch=3, img_h=376, img_w=1241,
                        device=cuda).process_chunk(lefts, rights)
    for n in range(5):
        card.same_bits(f"chunk frame {n}", StepResultAt(chunk, n), frames[n])


# ---- the stage clock (rso_torch.metrics.profiler.STAGE_CLOCK) -------------

@pytest.fixture
def stage_clock():
    """STAGE_CLOCK zeroed, and its marks off again after the test."""
    from rso_torch.metrics.profiler import STAGE_CLOCK

    STAGE_CLOCK.on = False
    STAGE_CLOCK.reset()
    yield STAGE_CLOCK
    STAGE_CLOCK.on = False
    STAGE_CLOCK.reset()


def _lanes_run(cfg, seqs, cam, n, dev):
    """A 2-lane BatchEngine over n frames: results and launches a frame."""
    from rso_torch.parallel import BatchEngine

    be = BatchEngine(cfg, cam, batch=2, img_h=376, img_w=1241, device=dev)
    out = []
    for i in range(n):
        reset_launches()
        res = be.process_frames(np.stack([s.frames[i][0] for s in seqs]),
                                np.stack([s.frames[i][1] for s in seqs]))
        out.append((res, dict(settle_launches())))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["engine", "batch"])
def test_cuda_marked_graph_equals_the_unmarked(cuda, stage_clock, entry):
    """A step captured with marks on (Engine over 20 frames, a 2-lane
    BatchEngine over 8) gives the unmarked graph's results bit for bit and
    the same launches a frame (settle_launches: marks are counted in
    neither); its clock charges every stage of the path, one gn_block mark
    a GN block run (eager warm-up frame included): the iterations, for the
    lanes the most of any lane."""
    from rso_torch.metrics.profiler import STAGES
    from rso_torch.synthetic import synthetic_config

    cfg = synthetic_config()
    n = 20 if entry == "engine" else 8
    seqs = [make_sequence(n_frames=n, n_points=2000, H=376, W=1241, seed=s)
            for s in range(2)]
    runs = []
    for on in (False, True):
        stage_clock.on = on
        if entry == "engine":
            eng = Engine(cfg, seqs[0].cam, device=cuda)
            runs.append([])
            for left, right in seqs[0].frames:
                reset_launches()
                res = eng.process_frame(left, right)
                runs[-1].append((res, dict(settle_launches())))
        else:
            runs.append(_lanes_run(cfg, seqs, seqs[0].cam, n, cuda))
    stage_clock.on = False
    for i, ((a, la), (b, lb)) in enumerate(zip(*runs)):
        card.same_bits(f"frame {i}", b, a)
        assert la == lb, f"frame {i} launches"
    ns, marks = stage_clock.settle()
    assert set(marks) == set(STAGES) - {"propagate", "lk"}
    assert all(ns[name] > 0 for name in marks), dict(ns)
    assert marks["_stg1"] == marks["update"] == n
    blocks = sum(int(r.num_it.max()) + int(r.num_it_final.max())
                 for r, _ in runs[1])
    assert marks["gn_block"] == blocks


@pytest.mark.gpu
def test_cuda_marks_off_leave_the_captured_segments_as_they_were(
        cuda, stage_clock):
    """With marks off the step's captured segments (pre, the GN blocks,
    mid, tail) have the nodes they had before marks were first on, and a
    fresh engine's after them; the variant captured with marks on has 13
    kernel nodes more: _stg1, _stg2, _stg3, two _stg4, ransac and _stg5 in
    pre, a gn_block in each block, _stg5 in mid, and _stg5, update and end
    in tail.  The composition around them does not depend on the marks."""
    from rso_torch.graphs import node_types
    from rso_torch.synthetic import synthetic_config

    cfg = synthetic_config()
    seq = make_sequence(n_frames=3, n_points=2000, H=376, W=1241)

    def segments(eng, i):
        v = list(eng._get_step(376, 1241)._variants.values())[i]
        return [node_types(seg.graph.raw_cuda_graph()) for seg in v.graphs[None]]

    eng = Engine(cfg, seq.cam, device=cuda)
    eng.process_frame(*seq.frames[0])
    plain = segments(eng, 0)
    stage_clock.on = True
    eng.process_frame(*seq.frames[1])
    marked = segments(eng, 1)
    stage_clock.on = False
    eng.process_frame(*seq.frames[2])
    assert len(eng._get_step(376, 1241)._variants) == 2
    assert segments(eng, 0) == plain
    fresh = Engine(cfg, seq.cam, device=cuda)
    fresh.process_frame(*seq.frames[0])
    assert segments(fresh, 0) == plain
    extra = [{t: m.get(t, 0) - p.get(t, 0) for t in set(m) | set(p)
              if m.get(t, 0) != p.get(t, 0)} for m, p in zip(marked, plain)]
    assert extra == [{0: 7}, {0: 1}, {0: 1}, {0: 1}, {0: 3}]
