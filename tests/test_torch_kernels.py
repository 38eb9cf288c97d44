"""rso_torch kernels: the PyTorch twins against the reference's TPU kernels
(run in Pallas interpret mode, as tests/test_kernels.py runs them), the
dispatch rule (CPU tensor -> twin, anything else -> kernel or raise).  The
CUDA kernels are held against the twins in tests/test_torch_cuda.py.

Tolerances:
  * FAST mask, SAD indices and distances, SAD and Hamming matrices: exact
    (every SAD partial sum is an exact f32 multiple of 1/16 below 2^24
    units; Hamming distances are integer counts);
  * corner response vs the reference's jitted XLA composition: XLA's CPU
    backend contracts two multiply-adds into FMAs, so values differ in the
    last bits; rtol 1e-5 (with atol 1e-3 for responses near zero);
  * null vectors: the twin runs nullvec9_jnp's algorithm (atol 1e-4 on unit
    vectors: the Cholesky factors come from two LAPACK builds); against the
    LDL^T Pallas kernel, the same direction up to sign (|cos| > 1 - 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_stereo_cases as SC
import _torch_track_cases as TC
import _torch_card as card

from rso.kernels.cost_volume import windowed_sad_search as j_windowed_sad_search
from rso.kernels.distance import (
    hamming_matrix_jnp,
    hamming_matrix_pallas,
    sad_matrix_pallas,
)
from rso.kernels.fast_detect import corner_response_jnp
from rso.kernels.smallchol import nullvec9_jnp, nullvec9_pallas
from rso.kernels.stereo_fused import stereo_sad_fused, track_sad_fused
from rso_torch import kernels as K
from rso_torch.kernels import _lib
from rso_torch.synthetic import make_sequence


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def image():
    seq = make_sequence(n_frames=1, n_points=800, H=120, W=160)
    return seq.frames[0][0].astype(np.float32)


def _stereo_case(K_, seed):
    r = np.random.default_rng(seed)
    # right slot j sees left feature perm[j]: a noisy copy of its patch at a
    # disparity of -2..40 px and a row offset of -1..1 px
    perm = r.permutation(K_)
    pl = (r.integers(0, 255 * 16, (K_, 64)) / 16.0).astype(np.float32)
    pr = np.clip(pl[perm] + r.integers(-40, 40, (K_, 64)) / 16.0,
                 0, 255).astype(np.float32)
    xy_l = r.uniform(10, 300, (K_, 2)).astype(np.float32)
    xy_r = (xy_l[perm] - np.stack([r.uniform(-2, 40, K_), r.uniform(-1, 1, K_)],
                                  -1)).astype(np.float32)
    ok_l = r.random(K_) > 0.1
    ok_r = r.random(K_) > 0.1
    return pl, pr, xy_l, xy_r, ok_l, ok_r


def _track_case(K_, seed):
    r = np.random.default_rng(seed)
    base = [(r.integers(0, 255 * 16, (K_, 64)) / 16.0).astype(np.float32)
            for _ in range(2)]
    perm = r.permutation(K_)
    cur = [np.clip(b[perm] + r.integers(-30, 30, (K_, 64)) / 16.0, 0, 255)
           .astype(np.float32) for b in base]
    p_xy = r.uniform(20, 200, (K_, 2)).astype(np.float32)
    c_xy = (p_xy[perm] + r.uniform(-3, 3, (K_, 2))).astype(np.float32)
    p_rx = (p_xy[:, 0] - r.uniform(2, 30, K_)).astype(np.float32)
    c_rx = (c_xy[:, 0] - r.uniform(2, 30, K_)).astype(np.float32)
    return (base[0], cur[0], base[1], cur[1], p_xy, c_xy, p_rx, c_rx,
            r.random(K_) > 0.15, r.random(K_) > 0.15)


def _words(r, k):
    """[k,8] full-range uint32 descriptor words (about half >= 2^31)."""
    return r.integers(0, 2**32, (k, 8), dtype=np.uint64).astype(np.uint32)


def _rank8(rng, B):
    A = rng.normal(0, 1, (B, 8, 9)).astype(np.float32)
    return np.einsum("bki,bkj->bij", A, A)


@pytest.mark.parametrize("th", [10, 25])
def test_corner_twin_vs_reference(image, th):
    ref = np.asarray(jax.jit(corner_response_jnp)(jnp.asarray(image), th))
    out = K.corner_response_torch(torch.from_numpy(image),
                                  torch.tensor(th, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    fin = np.isfinite(ref)
    assert fin.sum() > 50
    np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("arc", [9, 12])
@pytest.mark.parametrize("win", [2, 4])
@pytest.mark.parametrize("hw", [(17, 23), (94, 310), (377, 1243)])
def test_corner_twin_vs_reference_noise(hw, win, arc):
    """Uniform noise of odd sizes: corners up to the 3-px ring on every edge,
    where the wrapped gradients and zero-padded box sums matter.  The
    reference's FMAs as in test_corner_twin_vs_reference (same tolerance)."""
    img = np.random.default_rng(hw[0] * hw[1]).uniform(0, 255, hw).astype(np.float32)
    ref = np.asarray(jax.jit(corner_response_jnp, static_argnums=(2, 3))(
        jnp.asarray(img), 20, arc, win))
    out = K.corner_response_torch(torch.from_numpy(img),
                                  torch.tensor(20, dtype=torch.int32), arc, win).numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    fin = np.isfinite(ref)
    assert fin[3:6].any() and fin[-6:-3].any() and fin[:, 3:6].any() and fin[:, -6:-3].any()
    np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("win", [7, 13, 46, 64])
def test_corner_twin_vs_reference_wide_window(win):
    """Windows wider than the configs' 4 (the kernel takes any win: 46 and
    64 take its wide path on the card), on uniform noise of an odd size;
    tolerance as above."""
    img = np.random.default_rng(win).uniform(0, 255, (94, 310)).astype(np.float32)
    ref = np.asarray(jax.jit(corner_response_jnp, static_argnums=(2, 3))(
        jnp.asarray(img), 20, 12, win))
    out = K.corner_response_torch(torch.from_numpy(img),
                                  torch.tensor(20, dtype=torch.int32), 12, win).numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    fin = np.isfinite(ref)
    assert fin.any()
    np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("K_", [128, 257])
def test_stereo_twin_vs_pallas(K_):
    pl, pr, xy_l, xy_r, ok_l, ok_r = _stereo_case(K_, K_)
    kw = dict(max_y_diff=1.0, max_disp=100.0, max_distance=1200.0)
    ref = stereo_sad_fused(*(jnp.asarray(a) for a in (pl, pr, xy_l, xy_r, ok_l, ok_r)),
                           interpret=True, **kw)
    out = K.stereo_sad_fused_torch(*(torch.from_numpy(a) for a in
                                     (pl, pr, xy_l, xy_r, ok_l, ok_r)), **kw)
    assert (np.asarray(ref[1]) < 1e9).sum() > K_ // 4   # real matches exist
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("K_", [128, 131])
def test_track_twin_vs_pallas(K_):
    args = _track_case(K_, K_)
    kw = dict(win_row=8.0, win_col=16.0, sad_max=1200.0)
    ref = track_sad_fused(*(jnp.asarray(a) for a in args), interpret=True, **kw)
    out = K.track_sad_fused_torch(*(torch.from_numpy(a) for a in args), **kw)
    assert (np.asarray(ref[1]) < 1e9).sum() > K_ // 4
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def _track_pallas(args, kw):
    """The Pallas track_sad_fused in interpret mode.  It takes as many cur
    slots as prev slots, so the shorter side is padded with invalid slots
    (never admissible, and past every real index) and the outputs cut back."""
    kp, kc = args[0].shape[0], args[1].shape[0]
    k = max(kp, kc)
    pad = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros((k - a.shape[0],) + a.shape[1:], a.dtype)])
    best_c, best_d = track_sad_fused(*(jnp.asarray(pad(a)) for a in args),
                                     interpret=True, **kw)
    return np.asarray(best_c)[:kp], np.asarray(best_d)[:kp]


@pytest.mark.parametrize("case", TC.CASES)
def test_track_twin_vs_pallas_cases(case):
    """The cases a kernel that masks before it forms any SAD must reproduce
    (tests/_torch_track_cases.py), twin against the reference's kernel."""
    args, kw, rows, cols = TC.track_case(case)
    ref = _track_pallas(args, kw)
    out = K.track_sad_fused_torch(*(torch.from_numpy(a) for a in args), **kw)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), r)
    best_c, best_d = ref
    share = card.track_window_pairs(tuple(torch.from_numpy(a) for a in args),
                                    kw) / (len(args[0]) * len(args[1]))
    assert share < 0.02 if case == "sparse" else True
    assert share > 0.9 if case == "dense" else True
    if case in ("no_admissible_rows", "ok_p_false", "one_eye_over_sad_max"):
        # nothing admissible is left: the argmin over a row of 1e9
        assert (best_c[rows] == 0).all() and (best_d[rows] == 1e9).all()
    else:
        assert (best_c[rows] == cols).all() and (best_d[rows] < 1e9).all()


def _stereo_pallas(args, kw):
    """The Pallas stereo_sad_fused in interpret mode.  It takes as many right
    slots as left slots, so the shorter side is padded with invalid slots
    (never admissible, and past every real index) and the outputs cut back."""
    kl, kr = args[0].shape[0], args[1].shape[0]
    k = max(kl, kr)
    pad = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros((k - a.shape[0],) + a.shape[1:], a.dtype)])
    out = stereo_sad_fused(*(jnp.asarray(pad(a)) for a in args),
                           interpret=True, **kw)
    return tuple(np.asarray(x)[:kl] for x in out)


@pytest.mark.parametrize("case", SC.CASES)
def test_stereo_twin_vs_pallas_cases(case):
    """The cases a kernel that masks before it forms any SAD must reproduce
    (tests/_torch_stereo_cases.py), twin against the reference's kernel."""
    args, kw, rows, cols, wins = SC.stereo_case(case)
    ref = _stereo_pallas(args, kw)
    out = K.stereo_sad_fused_torch(*(torch.from_numpy(a) for a in args), **kw)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), r)
    best_r, best_d, second = ref
    share = card.stereo_mask_pairs(tuple(torch.from_numpy(a) for a in args),
                                   kw) / (len(args[0]) * len(args[1]))
    assert share < 0.02 if case == "sparse" else True
    assert share > 0.4 if case == "open" else True
    assert (best_r[rows[wins]] == cols[wins]).all()
    assert (best_d[rows[wins]] < 1e9).all()
    lose = rows[~wins]   # the planted slot is not the match ((0, 1e9): none)
    assert ((best_r[lose] != cols[~wins]) | (best_d[lose] == 1e9)).all()
    if case in ("no_admissible_rows", "ok_l_false"):
        # nothing admissible: the argmin over a row of 1e9
        assert (best_r[rows] == 0).all() and (best_d[rows] == 1e9).all()
        assert (second[rows] == 1e9).all()
    if case == "one_admitted":
        assert (second[rows] == 1e9).all()
    if case == "equal_sads":
        assert (second[rows] == best_d[rows]).all()
    if case not in ("k1", "kl1_kr64", "kl64_kr1"):
        assert ((second < 1e9) & (second > best_d)).any()   # real seconds


def test_stereo_ties_keep_first_and_second_equals_best():
    """Two identical right patches: argmin takes the lower index and the
    second-best equals the best (only the argmin position is excluded)."""
    pl = np.zeros((2, 64), np.float32)
    pr = np.zeros((3, 64), np.float32)
    pr[2] = 5.0
    xy_l = np.array([[50.0, 10.0], [60.0, 10.0]], np.float32)
    xy_r = np.array([[40.0, 10.0], [45.0, 10.0], [30.0, 10.0]], np.float32)
    ok = np.ones(2, bool)
    best_r, best_d, second = K.stereo_sad_fused_torch(
        *(torch.from_numpy(a) for a in (pl, pr, xy_l, xy_r, ok, np.ones(3, bool))),
        max_y_diff=1.0, max_disp=100.0, max_distance=1e4)
    assert best_r.tolist() == [0, 0]
    assert best_d.tolist() == second.tolist() == [0.0, 0.0]


@pytest.mark.parametrize("ka,kb", [(131, 257), (200, 64)])
def test_hamming_twin_vs_pallas_and_jnp(ka, kb):
    r = np.random.default_rng(ka)
    a, b = _words(r, ka), _words(r, kb)
    b[:40] = a[:40]                                  # distance 0
    b[40:60] = a[:20] ^ np.uint32(2**31)     # each word differs in its top bit
    assert (a >= 2**31).mean() > 0.4
    ref = np.asarray(hamming_matrix_pallas(jnp.asarray(a), jnp.asarray(b),
                                           interpret=True))
    np.testing.assert_array_equal(
        np.asarray(hamming_matrix_jnp(jnp.asarray(a), jnp.asarray(b))), ref)
    out = K.hamming_matrix_torch(torch.from_numpy(a.view(np.int32)),
                                 torch.from_numpy(b.view(np.int32)))
    assert out.dtype == torch.float32 and out.shape == (ka, kb)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref[np.arange(20), 40 + np.arange(20)] == 8).all()


@pytest.mark.parametrize("w", [1, 7, 64])
def test_hamming_twin_vs_pallas_widths(w):
    """Widths other than the engine's 8 words (the CUDA kernel's run-time
    path): the twin equals the Pallas kernel."""
    r = np.random.default_rng(w)
    a = r.integers(0, 2**32, (67, w), dtype=np.uint64).astype(np.uint32)
    b = r.integers(0, 2**32, (131, w), dtype=np.uint64).astype(np.uint32)
    b[:30] = a[:30]
    ref = np.asarray(hamming_matrix_pallas(jnp.asarray(a), jnp.asarray(b),
                                           interpret=True))
    out = K.hamming_matrix_torch(torch.from_numpy(a.view(np.int32)),
                                 torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref[np.arange(30), np.arange(30)] == 0).all() and ref.max() > w * 16


@pytest.mark.parametrize("ka,kb", [(131, 257), (257, 200)])
def test_sad_matrix_twin_vs_pallas(ka, kb):
    r = np.random.default_rng(kb)
    a = (r.integers(0, 255 * 16, (ka, 64)) / 16.0).astype(np.float32)
    b = (r.integers(0, 255 * 16, (kb, 64)) / 16.0).astype(np.float32)
    ref = np.asarray(sad_matrix_pallas(jnp.asarray(a), jnp.asarray(b),
                                       interpret=True))
    out = K.sad_matrix_torch(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_dense_ties_take_the_first_index():
    """Crafted ties in a Hamming matrix: the dense stereo path's argmin takes
    the lowest right index, and the second-best equals the best."""
    from rso_torch.kernels.stereo_fused import _best_second

    a = np.zeros((3, 8), np.uint32)
    a[1, 0] = 0xFFFF0000
    b = np.zeros((5, 8), np.uint32)
    b[:, 0] = [1, 0xFFFF0001, 2, 0xFFFF0001, 4]     # rows 0, 2 tie for a[0]
    D = K.hamming_matrix_torch(torch.from_numpy(a.view(np.int32)),
                               torch.from_numpy(b.view(np.int32)))
    best, d, second = _best_second(D)
    ref = np.asarray(jnp.argmin(hamming_matrix_jnp(jnp.asarray(a),
                                                   jnp.asarray(b)), axis=1))
    assert best.tolist() == ref.tolist() == [0, 1, 0]
    assert d.tolist() == second.tolist() == [1.0, 1.0, 1.0]


def test_nullvec_twin_vs_jnp(rng):
    M = _rank8(rng, 96)
    ref = np.asarray(nullvec9_jnp(jnp.asarray(M)))
    out = K.nullvec9_torch(torch.from_numpy(M)).numpy()
    sign = np.sign(np.sum(ref * out, axis=1, keepdims=True))
    np.testing.assert_allclose(out * sign, ref, atol=1e-4)


def test_nullvec_twin_vs_pallas_up_to_sign(rng):
    M = _rank8(rng, 96)
    ref = np.asarray(nullvec9_pallas(jnp.asarray(M), interpret=True))
    out = K.nullvec9_torch(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-4)
    assert np.abs(np.sum(ref * out, axis=1)).min() > 1.0 - 1e-3
    resid = (np.linalg.norm(np.einsum("bij,bj->bi", M, out), axis=1)
             / np.trace(M, axis1=1, axis2=2))
    assert resid.max() < 1e-3


@pytest.mark.parametrize("B", [1, 2, 129])
def test_nullvec_twin_vs_pallas_batch_sizes(B):
    """RANSAC's refit shape (B = 2), one matrix, and one past the Pallas
    kernel's 128-lane padding: the same direction up to sign."""
    M = _rank8(np.random.default_rng(B), B)
    ref = np.asarray(nullvec9_pallas(jnp.asarray(M), interpret=True))
    out = K.nullvec9_torch(torch.from_numpy(M)).numpy()
    assert ref.shape == out.shape == (B, 9)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-4)
    assert np.abs(np.sum(ref * out, axis=1)).min() > 1.0 - 1e-3


def test_nullvec_twin_degenerate_inputs_finite(rng):
    A = rng.normal(0, 1, (16, 8, 9)).astype(np.float32)
    A[:, 4:] = A[:, :4]                                   # rank 4
    M = np.concatenate([np.einsum("bki,bkj->bij", A, A),
                        np.zeros((4, 9, 9), np.float32)])
    out = K.nullvec9_torch(torch.from_numpy(M)).numpy()
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-3)


def test_auto_takes_the_twin_for_cpu_tensors(image, rng):
    before = dict(_lib.LAUNCHES)
    img = torch.from_numpy(image)
    assert torch.equal(K.corner_response_auto(img, 20),
                       K.corner_response_torch(img, 20))
    M = torch.from_numpy(_rank8(rng, 4))
    assert torch.equal(K.nullvec9_auto(M), K.nullvec9_torch(M))
    d = torch.from_numpy(_words(rng, 9).view(np.int32))
    assert torch.equal(K.hamming_matrix_auto(d, d), K.hamming_matrix_torch(d, d))
    p = torch.from_numpy(rng.integers(0, 255, (9, 64)).astype(np.float32))
    assert torch.equal(K.sad_matrix_auto(p, p), K.sad_matrix_torch(p, p))
    assert dict(_lib.LAUNCHES) == before                  # no kernel launched


def test_non_cpu_tensor_never_falls_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel, whose library
    load fails here and raises; nothing drops to the twin."""
    def no_build():
        raise RuntimeError("nvcc not found (test)")

    monkeypatch.setattr(_lib, "_lib", None)
    monkeypatch.setattr(_lib, "build", no_build)
    meta = torch.empty((64, 64), device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.corner_response_auto(meta, 20)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.nullvec9_auto(torch.empty((4, 9, 9), device="meta"))
    p = torch.empty((8, 64), device="meta")
    xy = torch.empty((8, 2), device="meta")
    ok = torch.empty((8,), dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.stereo_sad_fused_auto(p, p, xy, xy, ok, ok, max_y_diff=1.0,
                                max_disp=10.0, max_distance=10.0)
    x = torch.empty((8,), device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.track_sad_fused_auto(p, p, p, p, xy, xy, x, x, ok, ok, win_row=1.0,
                               win_col=1.0, sad_max=1.0)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.sad_matrix_auto(p, p)
    d = torch.empty((8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.hamming_matrix_auto(d, d)


@pytest.mark.parametrize("win_x, win_y", [(8, 8), (4, 6), (3, 0), (16, 2)])
def test_windowed_sad_search_vs_reference(win_x, win_y):
    """rso's windowed SAD search (plain XLA in rso, plain PyTorch here) on a
    u8-valued image: best_xy and best_sad exact, with centers whose windows
    clamp at every border, half-pixel centers (round half to even), planted
    templates, repeated-value ties (the first minimum in row order) and
    invalid templates (float32's max)."""
    rng = np.random.default_rng(10 * win_x + win_y)
    h, w, k = 70, 95, 48
    img = rng.integers(0, 256, (h, w)).astype(np.float32)
    img[40:60, 10:40] = 7.0                 # a flat block: tied minima
    tm = rng.integers(0, 256, (k, 64)).astype(np.float32)
    cxy = np.stack([rng.uniform(-6, w + 5, k),
                    rng.uniform(-6, h + 5, k)], 1).astype(np.float32)
    cxy[:6] = [[10.5, 11.5], [12.5, 13.5], [0, 0], [w - 1, h - 1],
               [25.0, 50.0], [30.0, 45.0]]
    tm[4:6] = 7.0
    for i, (x, y) in enumerate([(50, 20), (70, 30), (33, 12)]):
        tm[6 + i] = img[y - 3:y + 5, x - 3:x + 5].reshape(64)
        cxy[6 + i] = (x + 2.0, y - 1.0)
    valid = rng.random(k) > 0.2
    valid[:9] = True
    ref = j_windowed_sad_search(jnp.asarray(img), jnp.asarray(tm),
                                jnp.asarray(cxy), win_x, win_y,
                                jnp.asarray(valid))
    out = K.windowed_sad_search(torch.from_numpy(img), torch.from_numpy(tm),
                                torch.from_numpy(cxy), win_x, win_y,
                                torch.from_numpy(valid))
    np.testing.assert_array_equal(out.best_xy.numpy(), np.asarray(ref.best_xy))
    np.testing.assert_array_equal(out.best_sad.numpy(), np.asarray(ref.best_sad))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert (out.best_sad.numpy()[~valid] == np.finfo(np.float32).max).all()
    assert (out.best_sad.numpy()[4:6] == 0).all()
    if win_x >= 2 and win_y >= 1:
        assert (out.best_sad.numpy()[6:9] == 0).all()
    default = K.windowed_sad_search(torch.from_numpy(img),
                                    torch.from_numpy(tm),
                                    torch.from_numpy(cxy), win_x, win_y)
    assert bool(default.valid.all())
    np.testing.assert_array_equal(default.best_xy.numpy(),
                                  out.best_xy.numpy())


def test_corner_kernel_takes_only_its_windows(monkeypatch):
    """No window at all raises in the wrapper, before any launch; a window
    past the one-tile path's 45 passes that check (the kernel's wide path
    takes it) and reaches the device check; the dispatcher never falls back
    to the twin."""
    monkeypatch.setattr(_lib, "load", lambda: None)
    meta = torch.empty((64, 64), device="meta")
    for win in (0, -1):
        with pytest.raises(ValueError, match="win must be >= 1"):
            K.corner_response_auto(meta, 20, win=win)
    for win in (46, 64):
        with pytest.raises(ValueError, match="image on meta"):
            K.corner_response_auto(meta, 20, win=win)


def test_missing_toolkit_raises(monkeypatch, tmp_path):
    """Without nvcc the build raises; it never returns a stand-in."""
    monkeypatch.setattr(_lib, "_lib", None)
    monkeypatch.setattr(_lib, "library_path",
                        lambda: tmp_path / "x" / "librso_kernels.so")
    monkeypatch.setattr(_lib.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib.load()


def test_library_key_covers_every_source():
    path = _lib.library_path()
    assert path.name == "librso_kernels.so"
    assert path.parent.parent.name == "rso_torch"
    assert {p.name for p in _lib._CSRC.glob("*.cu")} == {
        "fast_detect.cu", "stereo_fused.cu", "smallchol.cu", "distance.cu",
        "graph_cond.cu", "gn_iter.cu", "lk_track.cu", "ransac.cu"}
