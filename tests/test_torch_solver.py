"""rso_torch solvers against rso on the CPU: the fundamental-matrix RANSAC
(same key -> same draws -> same inliers) and the two-phase robust pose solve
on the tests/test_solver.py cases.

Tolerances: inlier masks, counts, error codes and iteration counts exact;
poses atol 1e-5 (float32 GN in another framework, converged to
min_mod_out_vector = 1e-3 steps on O(1) poses); squared residuals atol
1e-3 px^2 (projections of ~1000 px carry ~1e-4 px of float32 rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rso.config import LeastSquaresParams as JLS
from rso.geometry import StereoCamera as JCam, pose_inverse, project_stereo
from rso.solver import ransac_fundamental as j_ransac, solve_pose as j_solve
from rso_torch import random as R
from rso_torch.config import LeastSquaresParams as TLS
from rso_torch.geometry import StereoCamera as TCam
from rso_torch.solver import ransac_fundamental as t_ransac, solve_pose as t_solve

CAM_ARGS = dict(fx_l=718.856, fy_l=718.856, cx_l=607.19, cy_l=185.21,
                baseline=0.5371)
JCAM = JCam.make(**CAM_ARGS)
TCAM = TCam.make(**CAM_ARGS)
DEFAULT_POSE = np.asarray([0.01, -0.02, 0.005, 0.05, -0.02, 0.3], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_problem(seed, n=200, pose=DEFAULT_POSE, noise=0.0, n_outliers=0,
                 pad_to=None):
    """tests/test_solver.py make_problem, from a seed: prev/cur stereo
    observations of a random cloud under a known camera motion."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(-5, 5, n),
                    rng.uniform(5.0, 40.0, n)], -1).astype(np.float32)
    prev = np.asarray(project_stereo(JCAM, jnp.asarray(pts), jnp.zeros(6)))
    cur = np.asarray(project_stereo(JCAM, jnp.asarray(pts),
                                    pose_inverse(jnp.asarray(pose))))
    if noise > 0:
        prev = prev + rng.normal(0, noise, prev.shape).astype(np.float32)
        cur = cur + rng.normal(0, noise, cur.shape).astype(np.float32)
    mask = np.ones(n, bool)
    if n_outliers:
        idx = rng.choice(n, n_outliers, replace=False)
        cur[idx] += rng.uniform(20, 60, (n_outliers, 4)).astype(np.float32)
    if pad_to and pad_to > n:
        pad = pad_to - n
        prev = np.concatenate([prev, np.zeros((pad, 4), np.float32)])
        cur = np.concatenate([cur, np.zeros((pad, 4), np.float32)])
        mask = np.concatenate([mask, np.zeros(pad, bool)])
    return prev.astype(np.float32), cur.astype(np.float32), mask


CASES = {
    "exact": dict(),
    "noisy": dict(noise=0.5),
    "outliers": dict(noise=0.3, n_outliers=30),
    "masked_padding": dict(n=150, pad_to=256, noise=0.2),
    "too_few": dict(n=6),
    "identity": dict(pose=np.zeros(6, np.float32)),
    "larger_rotation": dict(pose=np.asarray([0.05, 0.1, -0.03, 0.2, 0.1, 1.0],
                                            np.float32), noise=0.2),
}


def _compare_solve(prev, cur, mask, jp, tp, init=None, weight=None):
    ref = j_solve(JCAM, jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(mask),
                  jp, initial_pose=None if init is None else jnp.asarray(init),
                  obs_weight=None if weight is None else jnp.asarray(weight))
    out = t_solve(TCAM, torch.from_numpy(prev), torch.from_numpy(cur),
                  torch.from_numpy(mask), tp,
                  initial_pose=None if init is None else torch.from_numpy(init),
                  obs_weight=None if weight is None else torch.from_numpy(weight))
    for name in ("valid", "error_code", "num_it", "num_it_final", "inliers"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(ref.pose), atol=1e-5)
    np.testing.assert_allclose(out.delta_pose.numpy(), np.asarray(ref.delta_pose),
                               atol=1e-5)
    r_ref, r_out = np.asarray(ref.residuals), out.residuals.numpy()
    fin = r_ref < 1e30
    np.testing.assert_array_equal(r_out < 1e30, fin)
    np.testing.assert_allclose(r_out[fin], r_ref[fin], rtol=0, atol=1e-3)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_pose_matches_reference(case):
    prev, cur, mask = make_problem(sorted(CASES).index(case), **CASES[case])
    _compare_solve(prev, cur, mask, JLS(), TLS())


def test_solve_pose_warm_start_and_weights():
    prev, cur, mask = make_problem(5, noise=0.3)
    init = np.asarray([0.0, 0.0, 0.0, 0.0, 0.0, -0.25], np.float32)
    weight = np.where(np.arange(len(mask)) % 3 == 0, 0.25, 1.0).astype(np.float32)
    _compare_solve(prev, cur, mask, JLS(), TLS(), init=init, weight=weight)


def test_solve_pose_no_robust_kernel():
    prev, cur, mask = make_problem(6, noise=0.3)
    _compare_solve(prev, cur, mask, JLS(use_robust_kernel=False),
                   TLS(use_robust_kernel=False))


def test_solve_pose_degenerate_bad_cond():
    """All points identical: H is singular; both flag a bad condition."""
    prev, cur, mask = make_problem(7, n=20)
    prev[:] = prev[0]
    cur[:] = cur[0]
    out = _compare_solve(prev, cur, mask, JLS(), TLS())
    assert not bool(out.valid)


def test_solve_pose_unported_backends_raise():
    prev, cur, mask = make_problem(8, n=20)
    args = (TCAM, torch.from_numpy(prev), torch.from_numpy(cur),
            torch.from_numpy(mask))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_solve(*args, TLS(solve_backend="eigh"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_solve(*args, TLS(use_lm=True))


def _ransac_case(seed, n=200, n_out=40, n_valid=None):
    """Two-view correspondences of a static cloud under a known motion, plus
    gross outliers; the first n_valid slots are valid."""
    prev, cur, _ = make_problem(seed, n=n, noise=0.2)
    rng = np.random.default_rng(seed + 1)
    idx = rng.choice(n, n_out, replace=False)
    cur[idx, :2] += rng.uniform(15, 40, (n_out, 2)).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[: n if n_valid is None else n_valid] = True
    return prev[:, :2].copy(), cur[:, :2].copy(), mask


@pytest.mark.parametrize("seed,n_valid", [(0, None), (1, 120), (2, 30)])
def test_ransac_same_inliers_for_same_key(seed, n_valid):
    p1, p2, mask = _ransac_case(seed, n_valid=n_valid)
    kj = jax.random.fold_in(jax.random.PRNGKey(7), seed)
    ref = j_ransac(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), kj,
                   n_iters=256, threshold=1.0)
    kt = R.fold_in(R.PRNGKey(7), seed)
    out = t_ransac(torch.from_numpy(p1), torch.from_numpy(p2),
                   torch.from_numpy(mask), kt, n_iters=256, threshold=1.0)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert int(out.n_inliers) == int(ref.n_inliers)
    assert bool(out.ok) == bool(ref.ok)
    assert bool(out.ok) and int(out.n_inliers) >= 8


def test_ransac_degenerate_passes_through():
    p1, p2, mask = _ransac_case(3, n_valid=5)
    out = t_ransac(torch.from_numpy(p1), torch.from_numpy(p2),
                   torch.from_numpy(mask), R.PRNGKey(1), n_iters=64)
    assert not bool(out.ok)
    np.testing.assert_array_equal(out.inliers.numpy(), mask)


def test_ransac_two_eyes_equal_two_single_calls():
    a1, a2, mask = _ransac_case(4)
    b1, b2, _ = _ransac_case(5)
    keys = R.split(R.PRNGKey(11))
    t = torch.from_numpy
    both = t_ransac(torch.stack([t(a1), t(b1)]), torch.stack([t(a2), t(b2)]),
                    t(mask), keys, n_iters=128)
    for e, (p1, p2) in enumerate([(a1, a2), (b1, b2)]):
        one = t_ransac(t(p1), t(p2), t(mask), keys[e], n_iters=128)
        assert torch.equal(both.inliers[e], one.inliers)
        assert int(both.n_inliers[e]) == int(one.n_inliers)


def test_ransac_injected_draws_replace_the_key():
    p1, p2, mask = _ransac_case(6)
    key = R.PRNGKey(3)
    t = torch.from_numpy
    from_key = t_ransac(t(p1), t(p2), t(mask), key, n_iters=64)
    injected = t_ransac(t(p1), t(p2), t(mask), R.PRNGKey(99), n_iters=64,
                        draws=R.uniform(key, (64, 8)))
    assert torch.equal(from_key.inliers, injected.inliers)
