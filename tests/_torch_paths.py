"""Engine parity of the preset, rectified, optical-flow, detect_every,
eigh/LM and textured paths: shared helpers.

The reference engine runs each path over 4 frames of the test scene
(make_sequence(1800 points, 160x240); the rectified path: the distorted,
misaligned rig of make_unrectified_sequence(1800 points, 160x240) through
compute_rectify_maps; the textured path: textured_config() on
make_textured_sequence at its 240x376), with `use_mxu_distance=False` (the
exact dense SAD,
where the default would take the TPU-only MXU shortlist).  The port then
starts from each reference state (`state_from_numpy`), steps one frame on
the CPU and is compared field by field, as tests/test_torch_engine.py does:
integers and masks exact, floats within its tolerances (keypoint xy 1e-3
px, poses 1e-5, residuals and cost 5e-3).  The subpixel refine and LK
move tracked positions by at most ~1e-4 px against the reference (another
summation order of their window sums, and XLA's FMA contraction of the
bilinear mix); they reach the StepResult only through the pose solve.

Two runs per path, as in tests/_torch_modes.py:
  * with `filter_fund_matrix=False` (for flow: its per-octave RANSAC off),
    every field is held as above;
  * with the configuration as it is, the RANSAC filter's 1 px Sampson gate
    can take a track or two either way (ROADMAP Queue 3): a frame whose
    tracked count and stage-5 set match is compared in full, another one
    holds detection, stereo matching, validity and error code exactly, the
    tracked counts within TRACK_SLACK and the pose within
    POSE_ATOL_OTHER_SET.

`rectified`: XLA's CPU backend contracts the remap's bilinear mix into FMAs
(top = fma(Ia, 1-fx, Ib fx), and so on); the port does not, so remapped
pixels differ by up to 2^-15: patches atol RECT_PATCH_ATOL and stereo
distances (sums of 64 of them) RECT_DIST_ATOL.  On frame 0 of the test
scene one FAST test `p - c > th` falls the other way on octave 1 (one
keypoint more or less: RECT_TIE_FRAMES, ROADMAP Queue 3); that frame holds
every count within 1 per octave instead.
"""
import dataclasses
import os

import jax
import numpy as np
import torch

from rso.config import load_config as j_load_config
from rso.engine import Engine as JEngine, init_state as j_init_state
from rso.io.calib import compute_rectify_maps as j_rectify_maps
from rso.synthetic import make_sequence as j_make_sequence
from rso.synthetic import make_textured_sequence as j_make_textured_sequence
from rso.synthetic import make_unrectified_sequence as j_unrectified
from rso.synthetic import synthetic_config as j_synthetic_config
from rso.synthetic import textured_config as j_textured_config
from rso_torch.config import load_config as t_load_config
from rso_torch.engine import make_step, state_from_numpy
from rso_torch.geometry import StereoCamera
from rso_torch.synthetic import synthetic_config as t_synthetic_config
from rso_torch.synthetic import textured_config as t_textured_config
from test_torch_engine import _flat, _tol

H, W = 160, 240
TEXTURED_HW = (240, 376)
N_FRAMES = 4
TRACK_SLACK = 2
POSE_ATOL_OTHER_SET = 3e-2
# frames of the rectified test scene where a remap rounding flips a tie
RECT_TIE_FRAMES = (0,)
RECT_PATCH_ATOL = 4e-5
RECT_DIST_ATOL = 2e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("kitti", "rectified", "flow", "detect_every", "eigh_lm", "textured")
_RUNS = {}


def _change(path: str, cfg, ransac: bool):
    """The path's configuration on top of cfg (either package's RSOConfig)."""
    rep = dataclasses.replace
    if path == "flow":
        cfg = cfg.replace(if_match=rep(cfg.if_match, ifm_method=3))
    elif path == "detect_every":
        # 1-to-1 matching off: a right slot claimed twice goes to the first
        # left slot in scan order (the default arbitration)
        cfg = cfg.replace(tpu=rep(cfg.tpu, detect_every=2),
                          lr_match=rep(cfg.lr_match,
                                       enable_robust_1to1_match=False))
    elif path == "eigh_lm":
        cfg = cfg.replace(least_squares=rep(cfg.least_squares,
                                            solve_backend="eigh", use_lm=True))
    if not ransac:
        cfg = cfg.replace(if_match=rep(cfg.if_match, filter_fund_matrix=False))
    return cfg


def config(path: str, ransac: bool, jax_side: bool = False):
    """The path's RSOConfig: rso's with jax_side, else rso_torch's."""
    if path == "kitti":
        load = j_load_config if jax_side else t_load_config
        cfg = load(os.path.join(REPO, "configs", "kitti.ini"))
    elif path == "textured":
        cfg = j_textured_config() if jax_side else t_textured_config()
    else:
        cfg = j_synthetic_config() if jax_side else t_synthetic_config()
    cfg = _change(path, cfg, ransac)
    if jax_side:
        cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu,
                                                  use_mxu_distance=False))
    return cfg


def scene(path: str, n_frames: int = N_FRAMES, h: int = H, w: int = W):
    """(sequence, rectify maps or None) of the reference's generators; the
    rectified path's camera is the rectified one; the textured path's size
    is TEXTURED_HW."""
    if path == "textured":
        return j_make_textured_sequence(n_frames=n_frames, H=TEXTURED_HW[0],
                                        W=TEXTURED_HW[1]), None
    if path != "rectified":
        return j_make_sequence(n_frames=n_frames, n_points=1800, H=h, W=w), None
    seq, calib = j_unrectified(n_frames=n_frames, n_points=1800, H=h, W=w)
    cam, map_l, map_r = j_rectify_maps(calib)
    return seq._replace(cam=cam), (map_l, map_r)


def reference_run(path: str, ransac: bool):
    """(seq, maps, states, results) of the reference engine, numpy trees;
    cached."""
    if (path, ransac) not in _RUNS:
        seq, maps = scene(path)
        cfg = config(path, ransac, jax_side=True)
        eng = JEngine(cfg, seq.cam, rectify_maps=maps)
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        hw = seq.frames[0][0].shape
        states, results = [to_np(j_init_state(cfg, hw))], []
        for left, right in seq.frames:
            results.append(to_np(eng.process_frame(left, right)))
            states.append(to_np(eng.state))
        _RUNS[(path, ransac)] = seq, maps, states, results
    return _RUNS[(path, ransac)]


def port_step(path: str, ransac: bool, frame: int):
    """One port step on the CPU from the reference's state before `frame`."""
    seq, maps, states, _ = reference_run(path, ransac)
    cam = StereoCamera.from_numpy(jax.tree_util.tree_map(np.asarray, seq.cam))
    left, right = seq.frames[frame]
    step = make_step(config(path, ransac), cam, *left.shape,
                     rectify_maps=maps)
    return step(state_from_numpy(states[frame], device="cpu"),
                torch.from_numpy(left), torch.from_numpy(right))


def _assert_trees_match(ours, ref, what, rectified=False):
    """test_torch_engine's comparison; on the rectified path patches and
    stereo distances within the remap's rounding."""
    a, b = _flat(ours), _flat(ref)
    assert a.keys() == b.keys(), what
    for path in a:
        x, y = a[path], b[path]
        assert x.shape == y.shape, f"{what}{path}: shape {x.shape} vs {y.shape}"
        if x.dtype.kind in "biu":
            np.testing.assert_array_equal(x, y.astype(x.dtype),
                                          err_msg=f"{what}{path}")
            continue
        atol, rtol = _tol(path)
        if rectified and path.endswith(".patch"):
            atol = RECT_PATCH_ATOL
        elif rectified and path.endswith(".dist"):
            atol = RECT_DIST_ATOL
        np.testing.assert_allclose(x, y, atol=atol, rtol=rtol,
                                   err_msg=f"{what}{path}")


def _check_counts(res, ref, what, feat_slack=0):
    """Detection and stereo matching, validity and error code (counts
    within feat_slack per octave), tracked counts within TRACK_SLACK, the
    pose within POSE_ATOL_OTHER_SET."""
    for name, slack in (("detected_feats", feat_slack),
                        ("stereo_matches", feat_slack), ("valid", 0),
                        ("error_code", 0)):
        d = np.abs(getattr(res, name).numpy().astype(np.int64)
                   - np.asarray(getattr(ref, name)).astype(np.int64)).max()
        assert d <= slack, f"{what} {name} differs by {d}"
    for name in ("tracked_feats_from_last_frame", "tracked_feats_from_last_KF"):
        d = abs(int(getattr(res, name)) - int(getattr(ref, name)))
        assert d <= TRACK_SLACK, f"{what} {name} differs by {d}"
    np.testing.assert_allclose(res.pose.numpy(), ref.pose,
                               atol=POSE_ATOL_OTHER_SET, err_msg=what)


def check_exact(path: str, frame: int):
    _, _, states, results = reference_run(path, False)
    state, result = port_step(path, False, frame)
    what = f"{path} frame {frame}"
    if path == "rectified" and frame in RECT_TIE_FRAMES:
        _check_counts(result, results[frame], what, feat_slack=1)
        return
    rect = path == "rectified"
    _assert_trees_match(result, results[frame], what + " result", rect)
    _assert_trees_match(state, states[frame + 1], what + " state", rect)


def check_with_ransac(path: str) -> int:
    """Every frame with the RANSAC filter on; returns how many frames the
    gate changed (see the module docstring)."""
    _, _, states, results = reference_run(path, True)
    changed = 0
    for frame in range(N_FRAMES):
        state, res = port_step(path, True, frame)
        ref, what = results[frame], f"{path} frame {frame}"
        if path == "rectified" and frame in RECT_TIE_FRAMES:
            _check_counts(res, ref, what, feat_slack=1)
            continue
        if (np.array_equal(res.track_mask.numpy(), ref.track_mask)
                and int(res.tracked_feats_from_last_frame)
                == int(ref.tracked_feats_from_last_frame)):
            rect = path == "rectified"
            _assert_trees_match(res, ref, what + " result", rect)
            _assert_trees_match(state, states[frame + 1], what + " state", rect)
            continue
        changed += 1
        _check_counts(res, ref, what)
        # the frame's own features and stereo matches become the next state
        ours, theirs = _flat(state.prev), _flat(states[frame + 1].prev)
        for p in ours:
            if not p.endswith("match_ids"):
                np.testing.assert_allclose(ours[p], theirs[p], atol=1e-3,
                                           rtol=1e-5, err_msg=what + p)
    return changed


def bench_scene_reference(path: str, n_frames: int,
                          scene_frames: int = 30) -> dict:
    """The reference engine (JAX on the CPU) over the first n_frames of
    chip_smoke.py's scene of the path: valid frames and ATE, which bound
    the phase there.  kitti, flow, detect_every and eigh_lm: the 30-frame
    bench scene (1241x376, 2000 points, speed 0.8, fx 718.856, baseline
    0.5371); rectified: the distorted rig of make_unrectified_sequence at
    EuRoC's 752x480 (1800 points) under configs/euroc.ini; textured:
    make_textured_sequence(n_frames, seed 0) at 1241x376 with the bench
    camera under textured_config() (its corridor's end wall depends on
    n_frames).  detect_every runs with 3 (and 1-to-1 matching on)."""
    from rso.geometry import StereoCamera as JCamera, pose_matrix
    from rso.metrics.ate import ate_rmse

    rep = dataclasses.replace
    if path == "rectified":
        seq, calib = j_unrectified(n_frames=n_frames, n_points=1800, H=480,
                                   W=752)
        cam, map_l, map_r = j_rectify_maps(calib)
        seq, maps = seq._replace(cam=cam), (map_l, map_r)
        cfg = j_load_config(os.path.join(REPO, "configs", "euroc.ini"))
    else:
        h, w = 376, 1241
        cam = JCamera.make(fx_l=718.856, fy_l=718.856, cx_l=w / 2.0,
                           cy_l=h / 2.0, baseline=0.5371)
        if path == "textured":
            seq = j_make_textured_sequence(n_frames=n_frames, H=h, W=w,
                                           cam=cam)
        else:
            seq = j_make_sequence(n_frames=scene_frames, n_points=2000, H=h,
                                  W=w, cam=cam, speed=0.8)
        maps = None
        cfg = config(path, True, jax_side=True)
        if path == "detect_every":
            cfg = j_synthetic_config().replace(
                tpu=rep(j_synthetic_config().tpu, detect_every=3))
    cfg = cfg.replace(tpu=rep(cfg.tpu, use_mxu_distance=False))
    eng = JEngine(cfg, seq.cam, rectify_maps=maps)
    T, last, poses, valid = np.eye(4), None, [np.eye(4)], 0
    for i, (left, right) in enumerate(seq.frames[:n_frames]):
        res = eng.process_frame(left, right)
        valid += bool(res.valid)
        if i == 0:
            continue
        if bool(res.valid):          # constant-velocity coast over gaps
            last = np.asarray(pose_matrix(res.pose), np.float64)
        if last is not None:
            T = T @ last
        poses.append(T.copy())
    return dict(path=path, frames=n_frames, valid=valid,
                ate=float(ate_rmse(np.stack(poses), seq.poses[:n_frames])))


if __name__ == "__main__":
    # python tests/_torch_paths.py PATH N_FRAMES (with JAX_PLATFORMS=cpu)
    import json
    import sys

    print(json.dumps(bench_scene_reference(sys.argv[1], int(sys.argv[2]))))
