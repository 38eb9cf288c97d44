"""The engine's seams against rso on the CPU: rectified input,
precomputed features and matches, the threshold and ID accessors, a repeat
after a chunk, and the configurations both packages refuse.

Tolerances: as tests/_torch_paths.py (integers and masks exact; keypoint xy
1e-3 px, poses 1e-5, residuals and cost 5e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_paths as P
import rso_torch.engine as te
from rso.config import DetectMethod, IFMatchMethod, StereoMatchMethod
from rso.engine import Engine as JEngine, init_state as j_init_state
from rso.engine import make_step as j_make_step
from rso.frontend.detect import detect_features as j_detect
from rso.synthetic import make_sequence as j_make_sequence
from rso.synthetic import synthetic_config as j_synthetic_config
from rso_torch.config import RSOConfig
from rso_torch.frontend.detect import Features
from rso_torch.geometry import StereoCamera
from rso_torch.synthetic import synthetic_config

H, W = P.H, P.W


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return j_make_sequence(n_frames=4, n_points=1800, H=H, W=W)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tcam(jcam):
    return StereoCamera.from_numpy(_np(jcam))


def _jcfg():
    """The reference's synthetic_config on its exact dense SAD (the fused
    kernels' semantics; the default is the TPU-only MXU shortlist)."""
    cfg = j_synthetic_config()
    return cfg.replace(tpu=dataclasses.replace(cfg.tpu, use_mxu_distance=False))


# ---- rectified input ---------------------------------------------------------

@pytest.mark.parametrize("frame", range(P.N_FRAMES))
def test_rectified_step_without_the_ransac_filter(frame):
    P.check_exact("rectified", frame)


def test_rectified_steps_with_the_ransac_filter():
    assert P.check_with_ransac("rectified") <= 1


@pytest.mark.parametrize("shift", [0.0, 3.0])
def test_integer_shift_maps_equal_the_reference(seq, shift):
    """Identity maps (shift 0) and a +3 px x-shift: every sample lands on a
    pixel, so the remap is exact and both engines agree field by field.
    The identity equals no maps at all; the shift moves features by -3 px
    (the reference's test_engine_seams.py cases)."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    maps = ((xs + shift, ys), (xs + shift, ys))
    cfg = synthetic_config()
    jeng = JEngine(_jcfg(), seq.cam, rectify_maps=maps)
    eng = te.Engine(cfg, _tcam(seq.cam), rectify_maps=maps, device="cpu")
    plain = te.Engine(cfg, _tcam(seq.cam), device="cpu")
    for i, (left, right) in enumerate(seq.frames[:2]):
        ref = _np(jeng.process_frame(left, right))
        ours = eng.process_frame(left, right)
        base = plain.process_frame(left, right)
        P._assert_trees_match(ours, ref, f"shift {shift} frame {i} result")
        P._assert_trees_match(eng.state, _np(jeng.state), f"shift {shift} state")
        if shift == 0.0:
            P._assert_trees_match(ours, _np(base), "identity maps vs none")
    # most keypoints of the shifted image sit 3 px left of one of the
    # plain image's (the rest: its zero-filled right edge and the budget)
    o0 = eng.state.prev.octaves[0].left
    b0 = plain.state.prev.octaves[0].left
    moved = o0.xy[o0.valid] + torch.tensor([shift, 0.0])
    hit = (torch.cdist(moved, b0.xy[b0.valid]).amin(1) < 1e-3).float().mean()
    assert hit > 0.8, hit


def test_rectification_end_to_end():
    """A distorted, misaligned rig through compute_rectify_maps and the
    engine on the CPU: every trackable frame valid, an accurate motion, and
    more matches and at most half the error of the pinhole assumption (the
    reference's TestUnrectifiedRig bounds, on the port's own generator)."""
    from rso_torch.geometry import pose_matrix
    from rso_torch.io.calib import compute_rectify_maps
    from rso_torch.synthetic import make_unrectified_sequence

    tseq, calib = make_unrectified_sequence(
        n_frames=5, n_points=1800, dist=(-0.28, 0.07, 0.001, -0.001, 0.0),
        rig_rot=(0.012, 0.02, 0.008))
    cam_rect, map_l, map_r = compute_rectify_maps(calib)

    def run(eng):
        nvalid, errs, nmatch = 0, [], []
        for i, (left, right) in enumerate(tseq.frames):
            res = eng.process_frame(left, right)
            nmatch.append(int(res.stereo_matches.sum()))
            if i and bool(res.valid):
                nvalid += 1
                M = pose_matrix(res.pose.double()).numpy()
                errs.append(np.linalg.norm(M[:3, 3]
                                           - tseq.rel_poses[i - 1][:3, 3]))
        return nvalid, (np.mean(errs) if errs else np.inf), np.mean(nmatch)

    nv_r, err_r, m_r = run(te.Engine(synthetic_config(), cam_rect,
                                     rectify_maps=(map_l, map_r), device="cpu"))
    nv_0, err_0, m_0 = run(te.Engine(synthetic_config(), tseq.cam,
                                     device="cpu"))
    assert nv_r == 4
    assert err_r < 0.06
    assert m_r > m_0 * 1.3
    assert err_r < err_0 * 0.5


# ---- precomputed features and matches --------------------------------------------

def _orb_like(cfg):
    rep = dataclasses.replace
    return cfg.replace(
        rectify=rep(cfg.rectify, nOctaves=1),
        detect=rep(cfg.detect, detect_method=DetectMethod.FAST_ORB,
                   orb_upright=True),
        lr_match=rep(cfg.lr_match, match_method=StereoMatchMethod.DESC_RBR,
                     orb_max_distance=64.0, max_y_diff=1.5,
                     enable_robust_1to1_match=True, use_z_gate=False),
        if_match=rep(cfg.if_match, ifm_method=IFMatchMethod.DESC_WIN,
                     orb_max_distance=64.0))


def _features(cfg, img):
    """The reference detector's upright FAST_ORB features of one image, as
    (rso Features, rso_torch Features)."""
    f = j_detect(jnp.asarray(img, jnp.float32), cfg.detect,
                 cfg.tpu.max_kps_per_octave, jnp.int32(20), need_desc=True)
    return f, Features(*(torch.from_numpy(np.array(np.asarray(v).view(np.int32)
                                                    if np.asarray(v).dtype == np.uint32
                                                    else np.asarray(v)))
                         for v in f))


def test_precomputed_feats(seq):
    """Injected features skip stages 1-2: both engines agree frame by frame."""
    jcfg = _orb_like(j_synthetic_config())
    jeng = JEngine(jcfg, seq.cam)
    eng = te.Engine(_orb_like(synthetic_config()), _tcam(seq.cam), device="cpu")
    for i, (left, right) in enumerate(seq.frames[:3]):
        jl, tl = _features(jcfg, left)
        jr, tr = _features(jcfg, right)
        ref = _np(jeng.process_precomputed([jl], [jr], img_hw=(H, W)))
        ours = eng.process_precomputed([tl], [tr], img_hw=(H, W))
        P._assert_trees_match(ours, ref, f"precomputed feats frame {i}")
        P._assert_trees_match(eng.state, _np(jeng.state), f"state {i}")
    assert int(ours.tracked_feats_from_last_frame) > 20


def test_precomputed_matches_and_dicts(seq):
    """Injected matches skip stage 3; features given as dicts (xy, response,
    desc) on the second frame."""
    jcfg = _orb_like(j_synthetic_config())
    jeng = JEngine(jcfg, seq.cam)
    eng = te.Engine(_orb_like(synthetic_config()), _tcam(seq.cam), device="cpu")
    li = np.arange(40)
    for i, (left, right) in enumerate(seq.frames[:2]):
        jl, tl = _features(jcfg, left)
        jr, tr = _features(jcfg, right)
        if i == 1:
            jl = tl = {"xy": np.asarray(jl.xy), "response": np.asarray(jl.response),
                       "desc": np.asarray(jl.desc)}
            jr = tr = {"xy": np.asarray(jr.xy), "desc": np.asarray(jr.desc)}
        ridx = (li * 7 + i) % 60
        ref = _np(jeng.process_precomputed([jl], [jr], matches=[(li, ridx)],
                                           img_hw=(H, W)))
        ours = eng.process_precomputed([tl], [tr], matches=[(li, ridx)],
                                       img_hw=(H, W))
        assert int(ours.stereo_matches[0]) == 40
        P._assert_trees_match(ours, ref, f"precomputed matches frame {i}")
        P._assert_trees_match(eng.state, _np(jeng.state), f"state {i}")


# ---- accessors, IDs, chunk + repeat ------------------------------------------------

def test_accessors_and_ids(seq):
    """The threshold accessors, set_ids, set_this_frame_as_kf and reset_ids
    leave the reference's state, between frames of both engines."""
    jeng = JEngine(_jcfg(), seq.cam)
    eng = te.Engine(synthetic_config(), _tcam(seq.cam), device="cpu")
    assert eng.get_fast_threshold() == jeng.get_fast_threshold()
    for e in (jeng, eng):
        e.set_fast_threshold(1000)
    assert eng.is_fast_th_max() and jeng.is_fast_th_max()
    assert eng.get_fast_threshold() == jeng.get_fast_threshold()
    for e in (jeng, eng):
        e.set_fast_threshold(-5)
    assert eng.is_fast_th_min() == jeng.is_fast_th_min()
    for e in (jeng, eng):
        e.reset_fast_threshold()
    assert eng.get_fast_threshold() == jeng.get_fast_threshold() == 20
    for v in (10.0, 1e4, -1.0):
        for e in (jeng, eng):
            e.set_orb_threshold(v)
        assert eng.get_orb_threshold() == jeng.get_orb_threshold()
        assert (eng.is_orb_th_min(), eng.is_orb_th_max()) == (
            jeng.is_orb_th_min(), jeng.is_orb_th_max())
    for e in (jeng, eng):
        e.set_orb_threshold(64.0)
    ops = (lambda e: e.set_this_frame_as_kf(),
           lambda e: e.set_ids(np.arange(5, 45)),
           lambda e: e.reset_ids(),
           lambda e: e.set_fast_threshold(25))
    for i, (left, right) in enumerate(seq.frames[:3]):
        ref = _np(jeng.process_frame(left, right))
        ours = eng.process_frame(left, right)
        P._assert_trees_match(ours, ref, f"frame {i}")
        for op in ops[i:i + 2]:
            op(jeng)
            op(eng)
            P._assert_trees_match(eng.state, _np(jeng.state), f"after op {i}")
    assert int(eng.state.last_kf_max_id) >= 0


def test_chunk_then_repeat(seq):
    """A repeat after a 3-frame chunk re-runs against the state before the
    chunk, as the reference's one-dispatch chunk leaves it."""
    jeng = JEngine(_jcfg(), seq.cam)
    eng = te.Engine(synthetic_config(), _tcam(seq.cam), device="cpu")
    lefts = np.stack([l for l, _ in seq.frames[:3]])
    rights = np.stack([r for _, r in seq.frames[:3]])
    for e in (jeng, eng):
        e.process_frame(*seq.frames[0])
    chunk_ref = _np(jeng.process_chunk(lefts[1:], rights[1:]))
    chunk = eng.process_chunk(lefts[1:], rights[1:])
    P._assert_trees_match(chunk, chunk_ref, "chunk")
    ref = _np(jeng.process_frame(*seq.frames[3], repeat=True))
    ours = eng.process_frame(*seq.frames[3], repeat=True)
    P._assert_trees_match(ours, ref, "repeat after the chunk")
    P._assert_trees_match(eng.state, _np(jeng.state), "state after the repeat")
    assert int(eng.state.frame_idx) == 2


# ---- configurations both packages refuse ------------------------------------------

def _flow(cfg):
    return cfg.replace(if_match=dataclasses.replace(cfg.if_match, ifm_method=3))


def _every(cfg):
    return cfg.replace(tpu=dataclasses.replace(cfg.tpu, detect_every=2))


def _desc(cfg):
    return cfg.replace(detect=dataclasses.replace(
        cfg.detect, detect_method=DetectMethod.FAST_ORB))


CASES = {
    "precomputed with flow": (_flow, "feats"),
    "precomputed matches with detect_every": (_every, "matches"),
    "detect_every with descriptors": (lambda c: _every(_desc(c)), None),
    "detect_every with flow": (lambda c: _every(_flow(c)), None),
    "flow with no img_hw": (_flow, "init_state"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_refuses_what_the_reference_refuses(seq, case):
    change, what = CASES[case]
    jcfg, tcfg = change(j_synthetic_config()), change(synthetic_config())
    assert isinstance(tcfg, RSOConfig)
    if what == "init_state":
        calls = (lambda: j_init_state(jcfg), lambda: te.init_state(tcfg, device="cpu"))
    else:
        calls = (lambda: j_make_step(jcfg, seq.cam, H, W, precomputed=what),
                 lambda: te.make_step(tcfg, _tcam(seq.cam), H, W,
                                      precomputed=what))
    messages = []
    for call in calls:
        with pytest.raises(ValueError) as err:
            call()
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_process_precomputed_refuses_flow(seq):
    jeng = JEngine(_flow(j_synthetic_config()), seq.cam)
    eng = te.Engine(_flow(synthetic_config()), _tcam(seq.cam), device="cpu")
    for e in (jeng, eng):
        with pytest.raises(ValueError, match="precomputed"):
            e.process_precomputed([None], [None], img_hw=(H, W))
