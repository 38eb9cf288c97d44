"""Engine parity of the detector / matcher / tracker modes: shared helpers.

The reference engine runs each configuration of
`rso_torch.synthetic.mode_config` (the blob-scene settings of
tests/test_modes.py) over 4 frames of make_sequence(1800 points, 160x240),
with `use_mxu_distance=False` (the exact dense SAD, where the default would
take the TPU-only MXU shortlist).  The port then starts from each reference
state (`state_from_numpy`), steps one frame on the CPU and is compared field
by field, as tests/test_torch_engine.py does.

Two runs per mode:
  * with `filter_fund_matrix=False`: every field exact (integers, masks,
    descriptors) or within test_torch_engine's float tolerances;
  * with the configuration as it is: the flat RANSAC filter's 1 px Sampson
    gate can take one track either way when keypoint xy differ by ~1e-4 px
    (the reference's FMA-contracted responses through the subpixel
    parabola, ROADMAP Queue 3).  A frame whose tracked count and stage-5
    set match is compared in full; otherwise detection, stereo matching,
    validity and error code stay exact, the tracked counts may differ by
    TRACK_SLACK,
    and the pose by POSE_ATOL_OTHER_SET (rotvec rad and translation m of a
    0.25 m step).  Measured: one such frame in 4 for FAST_ORB, KLT and
    adaptive NMS (tracked 59 vs 60, 34 vs 35 and 42 vs 44), none for ORB and
    the dense SAD path.
"""
import dataclasses

import jax
import numpy as np
import torch

from rso.engine import Engine as JEngine, init_state as j_init_state
from rso.synthetic import make_sequence as j_make_sequence
from rso_torch.engine import make_step, state_from_numpy
from rso_torch.geometry import StereoCamera
from rso_torch.synthetic import mode_config
from test_torch_engine import _assert_trees_match, _flat

H, W = 160, 240
N_FRAMES = 4
TRACK_SLACK = 2
POSE_ATOL_OTHER_SET = 3e-2
_RUNS = {}


def config(mode: str, ransac: bool):
    cfg = mode_config(mode)
    if not ransac:
        cfg = cfg.replace(if_match=dataclasses.replace(
            cfg.if_match, filter_fund_matrix=False))
    return cfg


def reference_run(mode: str, ransac: bool):
    """(seq, states, results) of the reference engine, numpy trees; cached."""
    if (mode, ransac) not in _RUNS:
        seq = j_make_sequence(n_frames=N_FRAMES, n_points=1800, H=H, W=W)
        cfg = config(mode, ransac)
        cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu,
                                                  use_mxu_distance=False))
        eng = JEngine(cfg, seq.cam)
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        states, results = [to_np(j_init_state(cfg, (H, W)))], []
        for left, right in seq.frames:
            results.append(to_np(eng.process_frame(left, right)))
            states.append(to_np(eng.state))
        _RUNS[(mode, ransac)] = seq, states, results
    return _RUNS[(mode, ransac)]


def port_step(mode: str, ransac: bool, frame: int):
    """One port step on the CPU from the reference's state before `frame`."""
    seq, states, _ = reference_run(mode, ransac)
    cam = StereoCamera.from_numpy(jax.tree_util.tree_map(np.asarray, seq.cam))
    step = make_step(config(mode, ransac), cam, H, W)
    left, right = seq.frames[frame]
    return step(state_from_numpy(states[frame], device="cpu"),
                torch.from_numpy(left), torch.from_numpy(right))


def check_exact(mode: str, frame: int):
    _, states, results = reference_run(mode, False)
    state, result = port_step(mode, False, frame)
    _assert_trees_match(result, results[frame], f"{mode} frame {frame} result")
    _assert_trees_match(state, states[frame + 1], f"{mode} frame {frame} state")


def check_with_ransac(mode: str) -> int:
    """Every frame with the RANSAC filter on; returns how many frames the
    gate changed (see the module docstring)."""
    _, states, results = reference_run(mode, True)
    changed = 0
    for frame in range(N_FRAMES):
        state, res = port_step(mode, True, frame)
        ref, what = results[frame], f"{mode} frame {frame}"
        if (np.array_equal(res.track_mask.numpy(), ref.track_mask)
                and int(res.tracked_feats_from_last_frame)
                == int(ref.tracked_feats_from_last_frame)):
            _assert_trees_match(res, ref, what + " result")
            _assert_trees_match(state, states[frame + 1], what + " state")
            continue
        changed += 1
        for name in ("detected_feats", "stereo_matches", "valid",
                     "error_code"):
            np.testing.assert_array_equal(getattr(res, name).numpy(),
                                          getattr(ref, name), err_msg=what + name)
        for name in ("tracked_feats_from_last_frame",
                     "tracked_feats_from_last_KF"):
            d = abs(int(getattr(res, name)) - int(getattr(ref, name)))
            assert d <= TRACK_SLACK, f"{what} {name} differs by {d}"
        np.testing.assert_allclose(res.pose.numpy(), ref.pose,
                                   atol=POSE_ATOL_OTHER_SET, err_msg=what)
        # the frame's own features and stereo matches become the next state
        ours, theirs = _flat(state.prev), _flat(states[frame + 1].prev)
        for path in ours:
            if not path.endswith("match_ids"):
                np.testing.assert_allclose(ours[path], theirs[path],
                                           atol=1e-3, rtol=1e-5,
                                           err_msg=what + path)
    return changed


def bench_scene_reference(mode: str, n_frames: int) -> dict:
    """The reference engine (JAX on the CPU) over chip_smoke.py's bench
    scene (1241x376, 2000 points, speed 0.8) in `mode` with oriented
    descriptors: valid frames and ATE, which bound chip_smoke.py's
    descriptor phase."""
    from rso.geometry import StereoCamera as JCamera, pose_matrix
    from rso.metrics.ate import ate_rmse

    h, w = 376, 1241
    cam = JCamera.make(fx_l=718.856, fy_l=718.856, cx_l=w / 2.0,
                       cy_l=h / 2.0, baseline=0.5371)
    seq = j_make_sequence(n_frames=n_frames, n_points=2000, H=h, W=w,
                          cam=cam, speed=0.8)
    cfg = mode_config(mode, upright=False)
    cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, use_mxu_distance=False))
    eng = JEngine(cfg, seq.cam)
    T, last, poses, valid = np.eye(4), None, [np.eye(4)], 0
    for i, (left, right) in enumerate(seq.frames):
        res = eng.process_frame(left, right)
        valid += bool(res.valid)
        if i == 0:
            continue
        if bool(res.valid):          # constant-velocity coast over gaps
            last = np.asarray(pose_matrix(res.pose), np.float64)
        if last is not None:
            T = T @ last
        poses.append(T.copy())
    return dict(mode=mode, frames=n_frames, valid=valid,
                ate=float(ate_rmse(np.stack(poses), seq.poses)))


if __name__ == "__main__":
    # python tests/_torch_modes.py MODE N_FRAMES (with JAX_PLATFORMS=cpu)
    import json
    import sys

    print(json.dumps(bench_scene_reference(sys.argv[1], int(sys.argv[2]))))
