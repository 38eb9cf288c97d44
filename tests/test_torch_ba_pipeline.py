"""VOWithBA, KeyframeCollector and refine_trajectory of rso_torch.ba against
rso.ba on the CPU.

Scene: make_sequence(n_frames=10, n_points=800, H=160, W=240,
yaw_rate=0.01); min_kf_gap=1 and min_tracked_ratio=1.0, so every frame is a
keyframe and every frame from the third on runs a window solve;
max_landmarks=256.  Both run with filter_fund_matrix=False: with the RANSAC
filter its 1 px gate can take a track either way (ROADMAP Queue 3), without
it every integer field of the engine's step matches, so the keyframes'
match IDs do.  The reference takes use_mxu_distance=False (the exact dense
SAD; the default would take the TPU-only MXU shortlist).  One reference
engine serves the file: each reference pipeline gets it, reset, in place of
the one it built, so the step compiles once.

Runs: the sliding window as it is, and with marginalize=True,
max_keyframes=4 (the window evicts from the fifth keyframe on).
Tolerances, measured on this scene:
  * is_keyframe and vo_valid exact; ba_cost None on the same frames, else
    within COST_RTOL (measured 3.5e-6);
  * pose_wc within POSE_ATOL (rotation entries and metres; measured
    1.3e-5): the engine's keypoints differ from the reference's by ~1e-4 px
    (its corner response is FMA-contracted by XLA), the solves round
    differently (tests/test_torch_ba.py), and each output pose carries the
    corrections of every solve before it;
  * the marginalization prior of the last window: H and b within
    PRIOR_RTOL of their largest entry (measured 6.5e-7), lin within
    POSE_ATOL (measured 1e-5): its inputs are the BA-refined poses above;
    H symmetric to SYM_RTOL of its largest entry (measured 5e-17, the
    reference's 8e-17: the eigenvalue clip rebuilds it as V w V^T);
  * KeyframeCollector: frame indices and match IDs exact, observations
    within OBS_ATOL px (measured 7.5e-5 px), VO poses within POSE_ATOL
    (measured 6.3e-6); refine_trajectory(window=4, overlap=2) over the 10
    keyframes: the reference solves its 4 windows on the 8-device CPU mesh
    (make_win_mesh(4, 2)), the port as a batch on the CPU; refined poses
    within POSE_ATOL (measured 1.5e-5).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from rso.ba.offline import KeyframeCollector as JCollector
from rso.ba.offline import refine_trajectory as j_refine
from rso.ba.pipeline import VOWithBA as JVOWithBA
from rso.engine import Engine as JEngine
from rso.geometry import pose_matrix as j_pose_matrix
from rso.synthetic import make_sequence
from rso.synthetic import synthetic_config as j_synthetic_config
from _torch_mesh_ranks import one_rank_group
from rso_torch.ba import (
    KeyframeCollector,
    VOWithBA,
    make_mesh,
    make_win_mesh,
    refine_trajectory,
)
from rso_torch.engine import Engine
from rso_torch.geometry import StereoCamera, pose_matrix
from rso_torch.synthetic import synthetic_config

COMMON = dict(min_kf_gap=1, min_tracked_ratio=1.0, max_landmarks=256)
RUNS = {"window": {}, "marginalized": {"marginalize": True,
                                       "max_keyframes": 4}}
COST_RTOL = 2e-5
POSE_ATOL = 5e-5
PRIOR_RTOL = 5e-6
SYM_RTOL = 1e-12
OBS_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    rep = dataclasses.replace
    jc = j_synthetic_config()
    jc = jc.replace(if_match=rep(jc.if_match, filter_fund_matrix=False),
                    tpu=rep(jc.tpu, use_mxu_distance=False))
    tc = synthetic_config()
    tc = tc.replace(if_match=rep(tc.if_match, filter_fund_matrix=False))
    return jc, tc


@pytest.fixture(scope="module")
def scene():
    """(sequence, reference config, port config, reference engine, port
    camera)."""
    seq = make_sequence(n_frames=10, n_points=800, H=160, W=240,
                        yaw_rate=0.01)
    jc, tc = _configs()
    tcam = StereoCamera.from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          seq.cam))
    return seq, jc, tc, JEngine(jc, seq.cam), tcam


@pytest.fixture(scope="module")
def runs(scene):
    """Per run: (reference pipeline, its results, port pipeline, its
    results)."""
    seq, jc, tc, jeng, tcam = scene
    out = {}
    for name, kw in RUNS.items():
        ref = JVOWithBA(jc, seq.cam, **COMMON, **kw)
        jeng.reset()
        ref.engine = jeng
        ours = VOWithBA(tc, tcam, device="cpu", **COMMON, **kw)
        out[name] = (ref, [ref.process_frame(l, r) for l, r in seq.frames],
                     ours, [ours.process_frame(l, r) for l, r in seq.frames])
    return out


@pytest.mark.parametrize("run", RUNS)
def test_vo_with_ba(runs, run):
    ref, ref_out, ours, our_out = runs[run]
    n_solves = 0
    for i, (a, b) in enumerate(zip(our_out, ref_out)):
        assert (a.is_keyframe, a.vo_valid) == (b.is_keyframe, b.vo_valid), i
        assert (a.ba_cost is None) == (b.ba_cost is None), i
        if b.ba_cost is not None:
            n_solves += 1
            assert a.ba_cost == pytest.approx(b.ba_cost, rel=COST_RTOL), i
        np.testing.assert_allclose(a.pose_wc, b.pose_wc, rtol=0,
                                   atol=POSE_ATOL, err_msg=f"frame {i}")
    assert all(a.is_keyframe for a in our_out)
    assert n_solves == len(our_out) - 2
    assert len(ours.window) == len(ref.window)


def test_marginalization_prior(runs):
    ref, _, ours, _ = runs["marginalized"]
    assert ours.window.prior is not None and ref.window.prior is not None
    for name, a, b in zip(("H", "b"), ours.window.prior, ref.window.prior):
        assert np.all(np.abs(a - b) <= PRIOR_RTOL * np.abs(b).max()), name
    np.testing.assert_allclose(ours.window.prior.lin, ref.window.prior.lin,
                               rtol=0, atol=POSE_ATOL)
    H = ours.window.prior.H
    assert np.all(np.isfinite(H))
    assert np.abs(H - H.T).max() <= SYM_RTOL * np.abs(H).max()


def _collect(engine, collector, frames, matrix):
    """VO over the frames with the collector observing; returns the
    per-frame camera-to-world poses (the first frame at the origin)."""
    T, poses = np.eye(4), []
    for i, (left, right) in enumerate(frames):
        res = engine.process_frame(left, right)
        if bool(res.valid):
            T = T @ matrix(res.pose)
        poses.append(T.copy())
        collector.observe(i, res, T)
    return np.stack(poses)


def test_keyframe_collector_and_refine_trajectory(scene):
    seq, jc, tc, jeng, tcam = scene
    jeng.reset()
    jcol = JCollector(jeng, jc, min_kf_gap=1)
    j_vo = _collect(jeng, jcol, seq.frames,
                    lambda p: np.asarray(j_pose_matrix(p)))
    teng = Engine(tc, tcam, device="cpu")
    tcol = KeyframeCollector(teng, tc, min_kf_gap=1)
    t_vo = _collect(teng, tcol, seq.frames,
                    lambda p: pose_matrix(p).numpy())
    assert tcol.kf_frame_idx == jcol.kf_frame_idx == list(range(10))
    for a, b in zip(tcol.kfs, jcol.kfs):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.obs, b.obs, rtol=0, atol=OBS_ATOL)
    np.testing.assert_allclose(t_vo, j_vo, rtol=0, atol=POSE_ATOL)

    ref = j_refine(seq.cam, jcol.kfs, jcol.kf_frame_idx, j_vo, window=4,
                   overlap=2)
    ours = refine_trajectory(tcam, tcol.kfs, tcol.kf_frame_idx, t_vo,
                             window=4, overlap=2, device="cpu")
    assert np.abs(ours - t_vo).max() > 1e-4       # the solve moved poses
    np.testing.assert_allclose(ours, ref, rtol=0, atol=POSE_ATOL)


def test_entry_points_default_to_the_gpu(scene):
    """Without a device the pipeline and the offline refinement ask for
    CUDA: here, where there is none, each raises instead of running on the
    CPU; a mesh that is not a torch DeviceMesh raises."""
    seq, _, tc, _, tcam = scene
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VOWithBA(tc, tcam)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        refine_trajectory(tcam, [], [], np.zeros((0, 4, 4)))
    with pytest.raises(ValueError, match="DeviceMesh"):
        VOWithBA(tc, tcam, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="DeviceMesh"):
        refine_trajectory(tcam, [], [], np.zeros((0, 4, 4)), mesh=object(),
                          device="cpu")


def test_one_rank_mesh(scene, runs):
    """VOWithBA on a one-rank 'lmk' mesh (its solves through
    distributed_bundle_adjust) gives the plain window run's results bit for
    bit; so does refine_trajectory on a one-rank ('win','lmk') mesh against
    its one-device batch."""
    seq, _, tc, _, tcam = scene
    with one_rank_group():
        ours = VOWithBA(tc, tcam, device="cpu", mesh=make_mesh(device="cpu"),
                        **COMMON)
        got = [ours.process_frame(l, r) for l, r in seq.frames]
        for i, (a, b) in enumerate(zip(got, runs["window"][3])):
            assert (a.is_keyframe, a.vo_valid, a.ba_cost) == (
                b.is_keyframe, b.vo_valid, b.ba_cost), i
            np.testing.assert_array_equal(a.pose_wc, b.pose_wc, err_msg=i)

        teng = Engine(tc, tcam, device="cpu")
        col = KeyframeCollector(teng, tc, min_kf_gap=1)
        vo = _collect(teng, col, seq.frames, lambda p: pose_matrix(p).numpy())
        kw = dict(window=4, overlap=2, device="cpu")
        np.testing.assert_array_equal(
            refine_trajectory(tcam, col.kfs, col.kf_frame_idx, vo,
                              mesh=make_win_mesh(1, 1, device="cpu"), **kw),
            refine_trajectory(tcam, col.kfs, col.kf_frame_idx, vo, **kw))
