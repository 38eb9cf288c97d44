"""Rectification, calibration, the unrectified-rig generator and the
engine-state checkpoint against rso on the CPU.

Tolerances: `bilinear_remap` within 2^-15 of the reference's pixel, 2 ulp
of a value in [128, 256) (XLA's CPU backend contracts the bilinear mix into
FMAs; the port rounds each product; 2^-15 is reached on these seeded
maps), 0 exactly where the map leaves the image, and exact on maps of
whole pixels; `compute_rectify_maps`, the calibration loaders,
`make_unrectified_sequence` and the checkpoint exact (the same numpy, and
the same bytes).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rso.frontend.pyramid as jp
import rso.io.calib as jcalib
from rso.engine import Engine as JEngine
from rso.io.checkpoint import load_state as j_load_state
from rso.io.checkpoint import save_state as j_save_state
from rso.synthetic import make_unrectified_sequence as j_unrectified
from rso.synthetic import synthetic_config as j_synthetic_config
import rso_torch.engine as te
import rso_torch.frontend.pyramid as tp
import rso_torch.io.calib as tcalib
from rso_torch.geometry import StereoCamera
from rso_torch.io import load_state, save_state
from rso_torch.synthetic import make_unrectified_sequence, synthetic_config
from test_torch_engine import _flat

H, W = 120, 160


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", range(5))
def test_bilinear_remap(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (H, W)).astype(np.float32)
    mx = rng.uniform(-3, W + 2, (H, W)).astype(np.float32)
    my = rng.uniform(-3, H + 2, (H, W)).astype(np.float32)
    mx[0, :5] = [-1.0, -0.5, 0.0, W - 1.0, W - 0.5]      # the edges of range
    my[0, :5] = [5.0, 5.0, 5.0, 7.0, 7.0]
    ref = np.asarray(jax.jit(jp.bilinear_remap)(img, mx, my))
    out = tp.bilinear_remap(torch.from_numpy(img), torch.from_numpy(mx),
                            torch.from_numpy(my)).numpy()
    outside = (mx < 0) | (mx > W - 1) | (my < 0) | (my > H - 1)
    assert outside.sum() > 100 and (~outside).sum() > 100
    np.testing.assert_array_equal(out[outside], 0.0)
    np.testing.assert_array_equal(ref[outside], 0.0)
    np.testing.assert_allclose(out, ref, atol=2.0 ** -15, rtol=0)


@pytest.mark.parametrize("dx,dy", [(0, 0), (3, 0), (-2, 5)])
def test_bilinear_remap_whole_pixels_exact(dx, dy):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (H, W)).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    ref = np.asarray(jp.bilinear_remap(jnp.asarray(img), jnp.asarray(xs + dx),
                                       jnp.asarray(ys + dy)))
    out = tp.bilinear_remap(torch.from_numpy(img), torch.from_numpy(xs + dx),
                            torch.from_numpy(ys + dy)).numpy()
    np.testing.assert_array_equal(out, ref)


def _calib(dist=(-0.28, 0.07, 0.001, -0.001, 0.0), rot=(0.012, 0.02, 0.008)):
    from scipy.spatial.transform import Rotation

    K = np.array([[320.0, 0, 188], [0, 321.0, 120], [0, 0, 1]])
    Kr = np.array([[318.0, 0, 186], [0, 319.0, 121], [0, 0, 1]])
    kw = dict(K_l=K, K_r=Kr, dist_l=np.asarray(dist), dist_r=np.asarray(dist) * 0.9,
              R_lr=Rotation.from_rotvec(rot).as_matrix(),
              t_lr=np.array([0.4, 0.01, -0.02]), size=(H, W))
    return jcalib.FullCalibration(**kw), tcalib.FullCalibration(**kw)


def _same_cam(tcam, jcam):
    for a, b in zip(tcam, jcam):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dist", [(0.0,) * 5, (-0.28, 0.07, 0.001, -0.001, 0.0)])
def test_compute_rectify_maps_equal(dist):
    jc, tc = _calib(dist)
    jcam, jl, jr = jcalib.compute_rectify_maps(jc)
    tcam, tl, tr = tcalib.compute_rectify_maps(tc)
    _same_cam(tcam, jcam)
    for a, b in zip(tl + tr, jl + jr):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_distort_equal():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.8, 0.8, (50, 2))
    d = np.array([-0.2, 0.05, 0.001, -0.002, 0.01])
    np.testing.assert_array_equal(tcalib._distort(pts, d), jcalib._distort(pts, d))


def test_calibration_loaders_equal(tmp_path):
    kitti = tmp_path / "calib.txt"
    kitti.write_text(
        "P0: 718.856 0 607.1928 0 0 718.856 185.2157 0 0 0 1 0\n"
        "P1: 718.856 0 607.1928 -386.1448 0 718.856 185.2157 0 0 0 1 0\n")
    _same_cam(tcalib.load_kitti_calib(str(kitti)),
              jcalib.load_kitti_calib(str(kitti)))
    ini = tmp_path / "cam.ini"
    ini.write_text("[CAMERA_PARAMS]\nresolution = [640 480]\n"
                   "cam0_intrinsic = [500.5 501.5 320.25 240.75]\n"
                   "baseline = 0.25\n")
    _same_cam(tcalib.load_mrpt_ini_calib(str(ini)),
              jcalib.load_mrpt_ini_calib(str(ini)))
    yaml = ("T_BS:\n  cols: 4\n  rows: 4\n  data: [{}]\n"
            "resolution: [752, 480]\n"
            "intrinsics: [458.654, 457.296, 367.215, 248.375]\n"
            "distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, "
            "1.76187114e-05]\n")
    eye = np.eye(4)
    right = eye.copy()
    right[0, 3] = 0.11
    paths = []
    for name, T in (("l.yaml", eye), ("r.yaml", right)):
        p = tmp_path / name
        p.write_text(yaml.format(", ".join(str(v) for v in T.ravel())))
        paths.append(str(p))
    jc, tc = jcalib.load_euroc_calib(*paths), tcalib.load_euroc_calib(*paths)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_make_unrectified_sequence_equal():
    """Same frames byte for byte, same poses and calibration."""
    jseq, jc = j_unrectified(n_frames=3, n_points=600, H=H, W=W)
    tseq, tc = make_unrectified_sequence(n_frames=3, n_points=600, H=H, W=W)
    for (jl, jr), (tl, tr) in zip(jseq.frames, tseq.frames):
        assert jl.tobytes() == tl.tobytes() and jr.tobytes() == tr.tobytes()
    np.testing.assert_array_equal(tseq.poses, jseq.poses)
    np.testing.assert_array_equal(tseq.rel_poses, jseq.rel_poses)
    _same_cam(tseq.cam, jseq.cam)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---- checkpoint ----------------------------------------------------------------

def _flow_cfg(cfg):
    return cfg.replace(if_match=dataclasses.replace(cfg.if_match, ifm_method=3))


@pytest.fixture(scope="module")
def two_states():
    """The reference's flow-mode state after 2 frames (it carries the
    pyramids), and the port's state from its own 2 frames."""
    jseq, _ = j_unrectified(n_frames=2, n_points=900, H=H, W=W)
    jcfg = _flow_cfg(j_synthetic_config())
    jeng = JEngine(jcfg, jseq.cam)
    for left, right in jseq.frames:
        jeng.process_frame(left, right)
    eng = te.Engine(_flow_cfg(synthetic_config()),
                    StereoCamera.from_numpy(jax.tree_util.tree_map(np.asarray, jseq.cam)),
                    device="cpu")
    for left, right in jseq.frames:
        eng.process_frame(left, right)
    return jeng.state, eng.state


def _equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_checkpoint_round_trip(two_states, tmp_path):
    state = two_states[1]
    path = str(tmp_path / "port.npz")
    save_state(path, state)
    back = load_state(path, _flow_cfg(synthetic_config()), (H, W), device="cpu")
    _equal(back, state)
    assert len(back.prev_pyr_l) == 3


def test_reference_checkpoint_loads_into_the_port(two_states, tmp_path):
    """An NPZ written by rso.io.checkpoint.save_state loads equal to
    state_from_numpy of the same state."""
    jstate = two_states[0]
    path = str(tmp_path / "ref.npz")
    j_save_state(path, jstate)
    back = load_state(path, _flow_cfg(synthetic_config()), (H, W), device="cpu")
    _equal(back, te.state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                     device="cpu"))


def test_port_checkpoint_loads_into_the_reference(two_states, tmp_path):
    state = two_states[1]
    path = str(tmp_path / "port.npz")
    save_state(path, state)
    jback = j_load_state(path, _flow_cfg(j_synthetic_config()), (H, W))
    _equal(te.state_from_numpy(jax.tree_util.tree_map(np.asarray, jback),
                               device="cpu"), state)


def test_checkpoint_of_another_config_raises(two_states, tmp_path):
    path = str(tmp_path / "port.npz")
    save_state(path, two_states[1])
    with pytest.raises(ValueError, match="leaves"):
        load_state(path, synthetic_config(), (H, W), device="cpu")
    cfg = _flow_cfg(synthetic_config())
    cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, max_kps_per_octave=256))
    with pytest.raises(ValueError, match="shape"):
        load_state(path, cfg, (H, W), device="cpu")


def test_checkpoint_resume_continues_exactly(tmp_path):
    """Stepping on from a loaded state equals stepping on from the state."""
    seq, _ = make_unrectified_sequence(n_frames=3, n_points=900, H=H, W=W)
    cfg = synthetic_config()
    a = te.Engine(cfg, seq.cam, device="cpu")
    for left, right in seq.frames[:2]:
        a.process_frame(left, right)
    path = str(tmp_path / "mid.npz")
    save_state(path, a.state)
    b = te.Engine(cfg, seq.cam, device="cpu")
    b.state = load_state(path, cfg, (H, W), device="cpu")
    ra, rb = a.process_frame(*seq.frames[2]), b.process_frame(*seq.frames[2])
    _equal(ra, rb)
    _equal(a.state, b.state)
    assert os.path.getsize(path) > 0
