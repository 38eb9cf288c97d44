"""The detect_every path against rso on the CPU: LK propagation of the
previous frame's stereo pairs between detections (`_propagate`), its
scatter of right-eye positions, and the detect-or-propagate choice.

Tolerances: as tests/_torch_paths.py (integers and masks exact; keypoint xy
1e-3 px, poses 1e-5, residuals and cost 5e-3).

The free run holds chip_smoke.py's configuration of the path (detect_every
3, robust 1-to-1 matching, the RANSAC filter on) over 21 frames of the
160x240 test scene, each package free-running from its own first state:
every frame's StepResult and next state, with no tie on the way.  On the
21 bench frames (1241x376) the two part first at frame 3's pose (2.3e-5
against the 1e-5 tolerance; 1.5e-5 without the filter) and first in an
integer at frame 6, a near-tie of the RANSAC filter's hypotheses
(`tests/_torch_detect_every.py`, ROADMAP Queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_paths as P
import rso_torch.engine as te
from rso.engine import Engine as JEngine
from rso.engine import make_step as j_make_step
from rso.synthetic import make_sequence as j_make_sequence
from rso.synthetic import synthetic_config as j_synthetic_config
from rso_torch.geometry import StereoCamera
from rso_torch.synthetic import synthetic_config as t_synthetic_config

H, W = P.H, P.W
N_FREE = 21
_FREE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tcam(jcam):
    return StereoCamera.from_numpy(_np(jcam))


@pytest.mark.parametrize("frame", range(P.N_FRAMES))
def test_detect_every_step_without_the_ransac_filter(frame):
    P.check_exact("detect_every", frame)


def test_detect_every_steps_with_the_ransac_filter():
    assert P.check_with_ransac("detect_every") <= 1


def test_detect_every_alternates_detect_and_propagate():
    _, _, states, _ = P.reference_run("detect_every", False)
    since = [int(s.since_detect) for s in states[1:]]
    assert since == [0, 1, 0, 1], since


def test_set_last_is_xla_scatter_order():
    """_propagate's scatter: repeated targets resolve as XLA's scatter on
    the CPU applies them (the last write wins); out-of-range ones drop."""
    rng = np.random.default_rng(6)
    old = rng.normal(size=(40, 2)).astype(np.float32)
    vals = rng.normal(size=(40, 2)).astype(np.float32)
    tgt = rng.integers(0, 50, 40)          # repeats, and >= 40 drops
    ref = jnp.asarray(old).at[tgt].set(jnp.asarray(vals), mode="drop")
    moved = jnp.zeros(40, bool).at[tgt].set(True, mode="drop")
    new, written = te._set_last(torch.from_numpy(old), torch.from_numpy(tgt),
                                torch.from_numpy(vals))
    assert len(tgt) > len(np.unique(tgt))
    np.testing.assert_array_equal(new.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(written.numpy(), np.asarray(moved))


def test_propagate_with_shared_right_slots():
    """A state whose stereo matches share right slots (made by hand: both
    arbitration modes keep matching one-to-one on right slots) through a
    propagated frame: both engines write the shared slot alike."""
    seq, _, states, _ = P.reference_run("detect_every", False)
    st = states[1]                        # frame 1 propagates
    o0 = st.prev.octaves[0]
    ridx, valid = np.array(o0.matches.ridx), np.asarray(o0.matches.valid)
    pairs = np.flatnonzero(valid)
    ridx[pairs[1::2]] = ridx[pairs[0::2]][:len(pairs[1::2])]
    o0 = o0._replace(matches=o0.matches._replace(ridx=ridx))
    st = st._replace(prev=st.prev._replace(
        octaves=(o0,) + tuple(st.prev.octaves[1:])))
    cfg = P.config("detect_every", False, jax_side=True)
    ref_state, ref = jax.jit(j_make_step(cfg, seq.cam, H, W))(
        st, *seq.frames[1])
    step = te.make_step(P.config("detect_every", False), _tcam(seq.cam), H, W)
    state, res = step(te.state_from_numpy(st, device="cpu"),
                      *(torch.from_numpy(x) for x in seq.frames[1]))
    assert int(res.stereo_matches.sum()) > 0
    P._assert_trees_match(res, _np(ref), "shared slots result")
    P._assert_trees_match(state, _np(ref_state), "shared slots state")


def _every3(cfg):
    """chip_smoke.py's detect_every path on either package's config."""
    return cfg.replace(tpu=dataclasses.replace(cfg.tpu, detect_every=3))


def _free_runs():
    """Both engines free-running over N_FREE frames: (reference results,
    reference states after each frame, the port's likewise); cached."""
    if not _FREE:
        seq = j_make_sequence(n_frames=N_FREE, n_points=1800, H=H, W=W)
        jcfg = _every3(j_synthetic_config())
        jcfg = jcfg.replace(tpu=dataclasses.replace(jcfg.tpu,
                                                    use_mxu_distance=False))
        ref, port = JEngine(jcfg, seq.cam), te.Engine(
            _every3(t_synthetic_config()), _tcam(seq.cam), device="cpu")
        for name in ("ref_res", "ref_states", "res", "states"):
            _FREE[name] = []
        for left, right in seq.frames:
            _FREE["ref_res"].append(_np(ref.process_frame(left, right)))
            _FREE["ref_states"].append(_np(ref.state))
            _FREE["res"].append(port.process_frame(torch.from_numpy(left),
                                                   torch.from_numpy(right)))
            _FREE["states"].append(port.state)
    return _FREE


@pytest.mark.parametrize("frame", range(N_FREE))
def test_detect_every_free_run(frame):
    """Frame `frame` of the 21-frame free runs: the StepResult and the
    state after it, at the tolerances above."""
    runs = _free_runs()
    if frame == N_FREE - 1:
        since = [int(s.since_detect) for s in runs["ref_states"]]
        assert 0 < since.count(0) < N_FREE and max(since) == 2, since
    P._assert_trees_match(runs["res"][frame], runs["ref_res"][frame],
                          f"free run frame {frame} result")
    P._assert_trees_match(runs["states"][frame], runs["ref_states"][frame],
                          f"free run frame {frame} state")
