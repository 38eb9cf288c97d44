"""The sliding window, marginalization and the batched window solve of
rso_torch.ba against rso.ba on the CPU.

  * SlidingWindow (`build_problem`, `rel_measurements`, `prior_terms`,
    eviction with and without marginalization), `marginalize_oldest`,
    `schur_marginalize`, `split_into_windows` and `stitch_window_poses` are
    the reference's numpy code on the same inputs and must equal it bit for
    bit; the camera's floats are the same float32 values on both sides.
  * `window_sharded_bundle_adjust` solves its windows as a batch dimension.
    Against the port's own `bundle_adjust` window by window it is exact:
    poses, landmarks, cost, n_iters and converged (the window that
    converges early keeps its carry while the others iterate).  Against the
    reference's solve on make_win_mesh(2, 1) (3 windows: the reference pads
    a fourth, inactive one) poses within POSE_ATOL, landmarks within
    LMK_ATOL and costs within COST_RTOL (measured 5.8e-7 rad/m, 9.1e-4 m at
    5-30 m depth, 9.1e-6).  n_iters there are set by ties at the f32 noise
    floor of the cost, as tests/test_torch_ba.py explains (measured: window
    0 stops at 4 iterations there and 9 here; with the odometry prior
    window 1 at 8 and 4); the reference's own window solve and
    bundle_adjust part on these windows alike (with the prior, window 0:
    8 vs 9, window 1: 8 vs 4).  Where the two solves stop at different
    iterations, the test holds the port's cost, at the earlier stop, within
    FLOOR_RTOL of the converged cost.
"""
import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import rso.ba.marginalization as JM
import rso.ba.window as JWin
import rso.ba.window_sharded as JS
import rso_torch.ba.ba as T
import rso_torch.ba.marginalization as TM
import rso_torch.ba.window as TWin
import rso_torch.ba.window_sharded as TS
from rso_torch.geometry import StereoCamera
from test_marginalization import _make_window_kfs
from test_window_sharded import CAM as WIN_CAM, _make_problem

POSE_ATOL = 5e-6
LMK_ATOL = 3e-3
COST_RTOL = 2e-5
FLOOR_RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcam(cam):
    return StereoCamera.from_numpy(jax.tree_util.tree_map(np.asarray, cam))


def _keyframes(n_kf, n_lmk, seed):
    """The reference's synthetic keyframes (noisy stereo observations of a
    shared cloud; the first third of the landmarks seen only by the first
    two keyframes) and their camera."""
    cam, kfs, _ = _make_window_kfs(n_kf=n_kf, n_lmk=n_lmk, seed=seed)
    return cam, kfs


def _same_prior(ours, ref):
    assert (ours is None) == (ref is None)
    if ref is not None:
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("marginalize", [False, True])
def test_sliding_window(marginalize):
    """Keyframes in, one at a time past capacity: every problem, relative
    measurement and prior of both windows equal."""
    cam, kfs = _keyframes(6, 150, seed=5)
    tcam = _tcam(cam)
    kw = dict(max_keyframes=3, max_landmarks=64, marginalize=marginalize,
              marg_rel_w=(4e2, 25.0))
    ref = JWin.SlidingWindow(cam=cam, **kw)
    ours = TWin.SlidingWindow(cam=tcam, **kw)
    for kf in kfs:
        ref.add_keyframe(kf)
        ours.add_keyframe(TWin.KeyframeObs(*kf))
        assert len(ours) == len(ref)
        _same_prior(ours.prior, ref.prior)
        _same_prior(ours.prior_terms(), ref.prior_terms())
        np.testing.assert_array_equal(ours.rel_measurements(),
                                      ref.rel_measurements())
        if len(ref) < 2:
            continue
        rp, rids = ref.build_problem(cam)
        op, oids = ours.build_problem(tcam)
        np.testing.assert_array_equal(oids, rids)
        for name, a, b in zip(rp._fields, op, rp):
            assert a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    assert (ours.prior is not None) == marginalize


def test_apply_result():
    cam, kfs = _keyframes(3, 90, seed=6)
    ref, ours = JWin.SlidingWindow(3, 64), TWin.SlidingWindow(3, 64)
    for kf in kfs:
        ref.add_keyframe(kf)
        ours.add_keyframe(TWin.KeyframeObs(*kf))
    poses6 = np.random.default_rng(6).normal(0, 0.1, (3, 6)).astype(np.float32)
    np.testing.assert_array_equal(ours.apply_result(poses6),
                                  ref.apply_result(poses6))
    for a, b in zip(ours.keyframes, ref.keyframes):
        np.testing.assert_array_equal(a.pose_wc, b.pose_wc)


@pytest.mark.parametrize("chained", [False, True])
def test_marginalize_oldest(chained):
    """With the odometry factor, and with a previous prior absorbed."""
    cam, kfs = _keyframes(4, 160, seed=7)
    tcam = _tcam(cam)
    kw = dict(min_obs=2, rel_w=(4e2, 25.0))
    ref_prior = ours_prior = None
    if chained:
        ref_prior = JM.marginalize_oldest(cam, kfs[:3], None, **kw)
        ours_prior = TM.marginalize_oldest(tcam, kfs[:3], None, **kw)
        _same_prior(ours_prior, ref_prior)
    ref = JM.marginalize_oldest(cam, kfs[1:], ref_prior, **kw)
    ours = TM.marginalize_oldest(tcam, kfs[1:], ours_prior, **kw)
    _same_prior(ours, ref)
    assert ours.n == 2 and np.abs(ours.H).max() > 1.0


def test_schur_marginalize():
    r = np.random.default_rng(8)
    A = r.normal(size=(40, 40))
    H = A @ A.T + 1e-3 * np.eye(40)
    b = r.normal(size=40)
    keep = r.random(40) < 0.4
    for a, c in zip(TM.schur_marginalize(H, b, keep),
                    JM.schur_marginalize(H, b, keep)):
        np.testing.assert_array_equal(a, c)


def test_host_camera_reads_the_reference_floats():
    cam, _ = _keyframes(2, 30, seed=9)
    host = TM.host_camera(_tcam(cam))
    assert all(isinstance(v, float) for v in host)
    assert list(host) == [float(v) for v in cam]
    assert TM.host_camera(host) is host


@pytest.mark.parametrize("n,window,overlap", [(20, 8, 2), (9, 4, 2),
                                              (10, 4, 1), (8, 8, 3)])
def test_split_and_stitch(n, window, overlap):
    assert TS.split_into_windows(n, window, overlap) == \
        JS.split_into_windows(n, window, overlap)
    ranges = TS.split_into_windows(n, window, overlap)
    r = np.random.default_rng(n + window)
    per_win = [r.normal(0, 0.2, (window, 6)).astype(np.float32)
               for _ in ranges]
    np.testing.assert_array_equal(
        TS.stitch_window_poses(per_win, ranges, overlap, n),
        JS.stitch_window_poses(per_win, ranges, overlap, n))


def _window_problems():
    """Three windows: two with 0.2 px noise, one noiseless (it converges
    after 3 iterations, before the others)."""
    return [_make_problem(0), _make_problem(1), _make_problem(2, noise=0.0)]


def _port_problems(probs):
    return [T.ba_problem_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                    device="cpu") for p in probs]


PRIOR_CASES = {"plain": {}, "odometry_prior": {"rel_w_rot": 4e2,
                                               "rel_w_trans": 25.0}}


def _rels(probs):
    """Odometry measurements of each window: the relative motions of its
    starting poses."""
    out = []
    for p in probs:
        p6 = np.asarray(p.poses, np.float64)
        rel = []
        for a, b in zip(p6[:-1], p6[1:]):
            Ra = Rotation.from_rotvec(a[:3]).as_matrix()
            Rb = Rotation.from_rotvec(b[:3]).as_matrix()
            R = Rb @ Ra.T
            rel.append(np.concatenate([Rotation.from_matrix(R).as_rotvec(),
                                       b[3:] - R @ a[3:]]))
        out.append(np.stack(rel).astype(np.float32))
    return out


@pytest.mark.parametrize("case", PRIOR_CASES)
def test_batched_windows_equal_the_per_window_solve(case):
    probs = _port_problems(_window_problems())
    tcam = _tcam(WIN_CAM)
    kw = dict(PRIOR_CASES[case], max_iters=10)
    rels = _rels(_window_problems()) if case != "plain" else None
    outs = TS.window_sharded_bundle_adjust(tcam, probs, rel_meas=rels, **kw)
    iters = []
    for w, (p, out) in enumerate(zip(probs, outs)):
        single = T.bundle_adjust(tcam, p, rel_meas=None if rels is None
                                 else rels[w], **kw)
        for name, a, b in zip(out._fields, out, single):
            assert torch.equal(a, b), (w, name)
        iters.append(int(out.n_iters))
    assert iters[2] < max(iters), iters         # one window stopped early
    assert outs[2].converged


@pytest.mark.parametrize("case", PRIOR_CASES)
def test_batched_windows_against_the_reference_mesh(case):
    jprobs = _window_problems()
    probs = _port_problems(jprobs)
    tcam = _tcam(WIN_CAM)
    kw = dict(PRIOR_CASES[case], max_iters=10)
    rels = _rels(jprobs) if case != "plain" else None
    ref = JS.window_sharded_bundle_adjust(WIN_CAM, jprobs,
                                          JS.make_win_mesh(2, 1),
                                          rel_meas=rels, **kw)
    ours = TS.window_sharded_bundle_adjust(tcam, probs, rel_meas=rels, **kw)
    assert len(ours) == len(ref) == 3
    for w, (o, r) in enumerate(zip(ours, ref)):
        final = float(r.cost)
        assert float(o.cost) == pytest.approx(final, rel=COST_RTOL), w
        np.testing.assert_allclose(o.poses.numpy(), np.asarray(r.poses),
                                   rtol=0, atol=POSE_ATOL)
        np.testing.assert_allclose(o.lmks.numpy(), np.asarray(r.lmks),
                                   rtol=0, atol=LMK_ATOL)
        first_stop = min(int(o.n_iters), int(r.n_iters))
        if int(o.n_iters) != int(r.n_iters):
            at = TS.window_sharded_bundle_adjust(
                tcam, probs, rel_meas=rels, **dict(kw, max_iters=first_stop))
            assert abs(float(at[w].cost) - final) <= FLOOR_RTOL * final, w


def test_mesh_raises():
    """A mesh that is not a torch DeviceMesh raises (the mesh forms:
    tests/test_torch_mesh.py)."""
    tcam = _tcam(WIN_CAM)
    with pytest.raises(ValueError, match="DeviceMesh"):
        TS.window_sharded_bundle_adjust(tcam, _port_problems(
            _window_problems()[:1]), mesh=object())
