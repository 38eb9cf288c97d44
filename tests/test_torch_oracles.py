"""The port's host oracles on the CPU: rso_torch.native (the C++ kernels of
native/rso_native.cpp, built at first use) against the plain PyTorch twins
of the CUDA kernels, exact; rso_torch.baseline (the OpenCV port of the
reference solver, native/rso_baseline.cpp) against the port's solve_pose,
on the cases of tests/test_baseline_parity.py with its tolerances.  A
module skips where its library cannot be built (no g++, or no OpenCV 4
development files), as the reference's oracle tests do.
"""
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from rso_torch import baseline, native
from rso_torch.config import LeastSquaresParams
from rso_torch.frontend.detect import extract_patches, fast_corner_mask
from rso_torch.frontend.pyramid import downsample2x
from rso_torch.geometry import StereoCamera
from rso_torch.kernels import (
    corner_response_torch,
    hamming_matrix_torch,
    sad_matrix_torch,
)
from rso_torch.solver.robust_gn import solve_pose
from rso_torch.synthetic import make_sequence


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("rso_torch.native cannot be built here (g++)")


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(0).integers(0, 255, (120, 160),
                                             dtype=np.uint8)


def _patches(img, xy):
    return extract_patches(torch.from_numpy(img).to(torch.float32),
                           torch.from_numpy(xy.astype(np.float32)))


@pytest.mark.parametrize("threshold", [10, 25])
def test_fast_mask(lib, threshold):
    """The FAST mask of the twin, and of the corner response (finite where
    a corner), equal the scalar C++ FAST-12 as sets."""
    frame = make_sequence(n_frames=1, n_points=800, H=120, W=160).frames[0][0]
    theirs = set(map(tuple, native.fast_detect(frame, threshold,
                                               arc=12).tolist()))
    timg = torch.from_numpy(frame).to(torch.float32)
    for mask in (fast_corner_mask(timg, threshold, arc=12),
                 torch.isfinite(corner_response_torch(timg, threshold))):
        ys, xs = np.nonzero(mask.numpy())
        assert set(zip(xs.tolist(), ys.tolist())) == theirs
    assert len(theirs) > 0


def test_sad_matrix(lib, img):
    rng = np.random.default_rng(1)
    pa = _patches(img, rng.integers(10, 100, (33, 2)))
    pb = _patches(img, rng.integers(10, 100, (20, 2)))
    np.testing.assert_array_equal(
        sad_matrix_torch(pa, pb).numpy().astype(np.uint32),
        native.sad_matrix(pa.numpy().astype(np.uint8),
                          pb.numpy().astype(np.uint8)))


def test_hamming_matrix(lib):
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2**32, (32, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (48, 8), dtype=np.uint32)
    got = hamming_matrix_torch(torch.from_numpy(a.view(np.int32)),
                               torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  native.hamming_matrix(a, b))


def test_compute_sad8(lib, img):
    rng = np.random.default_rng(3)
    other = np.roll(img, 1, axis=1)
    for ax, ay, bx, by in rng.integers(10, 100, (16, 4)):
        pa = _patches(img, np.array([[ax, ay]]))
        pb = _patches(other, np.array([[bx, by]]))
        assert (native.compute_sad8(img, other, ax, ay, bx, by)
                == int(sad_matrix_torch(pa, pb)[0, 0]))
    assert native.compute_sad8(img, img, 50, 60, 50, 60) == 0


def _search(img, templ, cx, cy, wx, wy):
    """The windowed min-SAD search through the twins: every position of the
    window clamped 3 px / 5 px from the border, the first minimum in row
    order."""
    H, W = img.shape
    ys = np.arange(max(cy - wy, 3), min(cy + wy, H - 5) + 1)
    xs = np.arange(max(cx - wx, 3), min(cx + wx, W - 5) + 1)
    pos = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    sad = sad_matrix_torch(
        torch.from_numpy(templ.reshape(1, 64).astype(np.float32)),
        _patches(img, pos))[0].numpy()
    k = int(np.argmin(sad))
    return int(pos[k, 0]), int(pos[k, 1]), int(sad[k])


@pytest.mark.parametrize("cx, cy, wx, wy", [(84, 57, 8, 8), (5, 4, 6, 3),
                                            (150, 110, 12, 10)])
def test_tracking_sad(lib, img, cx, cy, wx, wy):
    tx, ty = 80, 60
    templ = img[ty - 3:ty + 5, tx - 3:tx + 5]
    got = native.tracking_sad(img, templ, cx, cy, wx, wy)
    assert got == _search(img, templ, cx, cy, wx, wy)
    if abs(cx - tx) <= wx and abs(cy - ty) <= wy:
        assert got == (tx, ty, 0)


def test_downsample2x(lib, img):
    """The C++ downsample rounds the 2x2 mean half up; the port's pyramid
    keeps it exact in float32."""
    ours = downsample2x(torch.from_numpy(img[:119, :159]).to(torch.float32))
    np.testing.assert_array_equal(
        native.downsample2x(img[:119, :159]),
        torch.floor(ours + 0.5).numpy().astype(np.uint8))


# ---- the baseline solver ---------------------------------------------------

CAM = StereoCamera.make(fx_l=320.0, fy_l=320.0, cx_l=188.0, cy_l=120.0,
                        baseline=0.4)
# exact reference iteration behaviour: rho' weights the gradient only
REF_PARAMS = LeastSquaresParams(irls_hessian_weighting=False)


def _correspondences(n=150, seed=0, noise=0.2, n_outliers=0,
                     w=(0.01, -0.02, 0.005), t=(0.05, -0.03, 0.2)):
    """tests/test_baseline_parity.py's correspondences: a cloud seen from
    two poses, noise and gross outliers on the current observations."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-8, 8, n), rng.uniform(-3, 3, n),
                  rng.uniform(4, 30, n)], -1)
    R = Rotation.from_rotvec(np.asarray(w)).as_matrix()
    Xc = X @ R.T + np.asarray(t)

    def proj(P):
        fx, cx, cy, b = (float(CAM.fx_l), float(CAM.cx_l), float(CAM.cy_l),
                         float(CAM.baseline))
        ul = fx * P[:, 0] / P[:, 2] + cx
        vl = fx * P[:, 1] / P[:, 2] + cy
        ur = fx * (P[:, 0] - b) / P[:, 2] + cx
        return np.stack([ul, vl, ur, vl], -1)

    prev = proj(X)
    cur = proj(Xc) + rng.normal(0, noise, (n, 4))
    if n_outliers:
        cur[:n_outliers] += rng.uniform(20, 60, (n_outliers, 4))
    return prev, cur


# name -> (correspondences, rows masked out and poisoned, params, initial
# pose, pose atol); the tolerances of tests/test_baseline_parity.py
SOLVES = {
    "clean": (dict(noise=0.0), 0, REF_PARAMS, None, 2e-5),
    "noisy": (dict(noise=0.3, seed=3), 0, REF_PARAMS, None, 5e-4),
    "outliers": (dict(noise=0.2, n_outliers=15, seed=5), 0, REF_PARAMS, None,
                 1e-3),
    "masked": (dict(noise=0.1, seed=7), 30, REF_PARAMS, None, 5e-4),
    "warm_start": (dict(noise=0.1, seed=11, t=(0.0, 0.0, 0.6)), 0, REF_PARAMS,
                   np.array([0.0, 0.0, 0.0, 0.0, 0.0, -0.5]), 5e-4),
    "no_robust_kernel": (dict(noise=0.05, seed=13), 0,
                         LeastSquaresParams(use_robust_kernel=False,
                                            irls_hessian_weighting=False),
                         None, 2e-4),
    "too_few_points": (dict(n=6), 0, REF_PARAMS, None, None),
}


@pytest.fixture(scope="module")
def baseline_lib():
    if not baseline.available():
        pytest.skip("rso_torch.baseline cannot be built here (OpenCV 4 dev)")


@pytest.mark.parametrize("case", SOLVES)
def test_baseline_solve_pose(baseline_lib, case):
    kw, n_masked, params, init, atol = SOLVES[case]
    prev, cur = _correspondences(**kw)
    mask = np.ones(len(prev), bool)
    mask[:n_masked] = False
    cur[:n_masked] = 1e6            # masked rows must not count
    ref_pose, ref_ok, _ = baseline.solve_pose(prev, cur, mask, CAM, params,
                                              init)
    out = solve_pose(CAM, torch.from_numpy(prev), torch.from_numpy(cur),
                     torch.from_numpy(mask), params,
                     None if init is None else torch.from_numpy(init))
    if atol is None:
        assert not ref_ok and not bool(out.valid)
        return
    assert ref_ok and bool(out.valid)
    np.testing.assert_allclose(out.pose.numpy(), ref_pose, atol=atol)
    if case == "outliers":          # both found the true (inverted) motion
        assert np.linalg.norm(ref_pose[3:] - [-0.05, 0.03, -0.2]) < 0.02
