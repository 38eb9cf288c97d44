"""rso_torch kernels: the PyTorch twins against the reference's TPU kernels
(run in Pallas interpret mode, as tests/test_kernels.py runs them), the
dispatch rule (CPU tensor -> twin, anything else -> kernel or raise).  The
CUDA kernels are held against the twins in tests/test_torch_cuda.py.

Tolerances:
  * FAST mask, SAD indices and distances: exact (every SAD partial sum is an
    exact f32 multiple of 1/16 below 2^24 units);
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
        "fast_detect.cu", "stereo_fused.cu", "smallchol.cu"}
