"""The port's batched engine against rso's BatchEngine on more paths.

As tests/test_torch_batch.py's first test (B = 3, make_sequence seeds 0-2,
1200 points, 120x160; here 3 frames): from the reference's batched state
before each frame the port's BatchEngine steps one frame, and its results
and next states equal the reference's, integers exactly and floats at
tests/test_torch_engine.py's tolerances.  The paths:

  kitti          configs/kitti.ini (subpixel refine on)
  flow           OPTICAL_FLOW tracking (LK in both eyes, per-octave RANSAC)
  detect_every   tests/_torch_paths.py's detect_every (2, 1-to-1 off), with
                 lane 1's `since_detect` set to 1 before frame 1 in both
                 engines' states: at frame 1 lane 1 detects while lanes 0
                 and 2 propagate, so the port runs the step's mixed branch
                 (both branches, each lane its own), the reference its
                 lax.cond under vmap; at frame 2 every lane detects
  descriptor     mode_config("fast_orb_rbr_win"): FAST_ORB + DESC_RBR +
                 DESC_WIN (kernel 5's Hamming matrices)

Each path's reference BatchEngine jit-compiles once (~20 s).
"""
import jax.numpy as jnp
import pytest

import rso_torch.parallel as tp
from _torch_paths import config as path_config
from rso_torch.engine import MIXED
from rso_torch.synthetic import mode_config
from test_torch_batch import (_one_torch_thread,  # noqa: F401
                              check_steps_from_reference,
                              reference_batch_run)

N_FRAMES = 3
# (frame, lane) whose flat RANSAC filter takes another track set than the
# reference's, as a lone step of the port does from the same state
# (test_torch_batch.check_steps_from_reference): flow's frame 2 of seed 1,
# 14 tracks against 13
CHANGED = {"flow": [(2, 1)]}


def _detect_lane_1(frame, states):
    if frame != 1:
        return states
    since = jnp.asarray(states.since_detect).at[1].set(1)
    return states._replace(since_detect=since)


CASES = {
    "kitti": (lambda: path_config("kitti", True, jax_side=True),
              lambda: path_config("kitti", True), None),
    "flow": (lambda: path_config("flow", True, jax_side=True),
             lambda: path_config("flow", True), None),
    "detect_every": (lambda: path_config("detect_every", True, jax_side=True),
                     lambda: path_config("detect_every", True),
                     _detect_lane_1),
    "descriptor": (lambda: mode_config("fast_orb_rbr_win"),
                   lambda: mode_config("fast_orb_rbr_win"), None),
}


@pytest.mark.parametrize("path", sorted(CASES))
def test_steps_from_the_reference_batch_states(path, monkeypatch):
    j_cfg, t_cfg, edit = CASES[path]
    run = reference_batch_run(j_cfg(), N_FRAMES, edit)
    branches = []
    real = tp.lanes_detect

    def recording(cfg, st):
        branches.append(real(cfg, st))
        return branches[-1]

    monkeypatch.setattr(tp, "lanes_detect", recording)
    changed = check_steps_from_reference(t_cfg(), *run, N_FRAMES)
    assert changed == CHANGED.get(path, [])
    if path == "detect_every":
        assert branches == [True, MIXED, True]
