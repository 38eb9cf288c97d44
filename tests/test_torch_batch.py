"""The port's batched engine (rso_torch.parallel.BatchEngine) on the CPU.

BatchEngine steps B sequences as one `torch.func.vmap` of make_step's step
a frame (rso's `jax.jit(jax.vmap(step))`).  Held here:

  * against rso's BatchEngine (B = 3, make_sequence seeds 0-2, 1200
    points, 120x160, 4 frames, `use_mxu_distance=False` on the reference as
    in tests/test_torch_engine.py): from the reference's batched state
    before each frame (`state_from_numpy` carries it across) the port's
    batched step gives the reference's results and next states, integers
    exact and floats at test_torch_engine's tolerances; and a free run of
    the port's own states gives the reference's results;
  * against the port's Engine, sequence by sequence: process_frames and
    process_chunk give each lane's integer fields exactly and its floats
    within BATCH_POSE_ATOL / BATCH_RES_ATOL, and process_chunk equals
    process_frames bit for bit;
  * the vmap code itself: `any_lane` and its rule, `cho_inverse`'s rule,
    `_pairwise_sum`, and that the step runs once a frame for all lanes.

Where a lane parts from a lone Engine: on the CPU the batched step's floats
differ from a lone step's at float32 rounding, from three operations whose
batched form sums in another order: the GN gradient's einsum
(robust_gn._eval_rgn), the H^-1 g product and the batched triangular
solves; integers stay equal.  Measured over every lane and frame of these
tests (tests/_torch_batch_gaps.py): pose <= 6.9e-7, squared residuals <=
5.5e-5, cost <= 1.7e-5.  The
bounds below are rso's own batch test's (pose atol 1e-5,
tests/test_parallel.py) and the engine tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rso.engine import init_state as j_init_state
from rso.engine import make_step as j_make_step
from rso.parallel import BatchEngine as JBatchEngine
from rso.synthetic import make_sequence as j_make_sequence
import rso_torch.parallel as tp
from _torch_paths import TRACK_SLACK
from rso_torch.engine import Engine, make_step, state_from_numpy
from rso_torch.geometry import StereoCamera
from rso_torch.graphs import leaves, tree_map
from rso_torch.solver import ransac as t_ransac
from rso_torch.solver import robust_gn
from rso_torch.synthetic import make_sequence, synthetic_config
from test_torch_engine import _assert_trees_match

B, N_FRAMES, H, W = 3, 4, 120, 160
BATCH_POSE_ATOL = 1e-5
BATCH_RES_ATOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sequences(n_frames=N_FRAMES):
    return [make_sequence(n_frames=n_frames, n_points=1200, H=H, W=W, seed=s)
            for s in range(B)]


def images(seqs, frame):
    return (np.stack([s.frames[frame][0] for s in seqs]),
            np.stack([s.frames[frame][1] for s in seqs]))


def reference_cfg(cfg):
    return cfg.replace(tpu=dataclasses.replace(cfg.tpu,
                                               use_mxu_distance=False))


class _VmappedStep:
    """rso's BatchEngine in its own form, jax.jit(jax.vmap(step))
    (rso/parallel.py:38), over init_state(cfg, (H, W)) broadcast to B: the
    paths whose state carries the previous pyramids (OPTICAL_FLOW,
    detect_every > 1), for which rso's BatchEngine cannot build its states
    (rso/parallel.py:41 calls init_state(cfg) without the image size, which
    raises)."""

    def __init__(self, cfg, cam):
        self._step = jax.jit(jax.vmap(j_make_step(cfg, cam, H, W)))
        self.states = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (B,) + x.shape),
            j_init_state(cfg, (H, W)))

    def process_frames(self, lefts, rights):
        self.states, results = self._step(self.states, jnp.asarray(lefts),
                                          jnp.asarray(rights))
        return results


def reference_batch_run(cfg, n_frames=N_FRAMES, edit=None):
    """rso's BatchEngine over the B sequences (`_VmappedStep` where it
    cannot build its states): (camera, the batched states before and after
    every frame, results), numpy trees.  `edit(frame, states) -> states`
    changes the reference's states before a frame (both sides then start
    that frame from the edited state)."""
    seqs = [j_make_sequence(n_frames=n_frames, n_points=1200, H=H, W=W,
                            seed=s) for s in range(B)]
    cfg = reference_cfg(cfg)
    if cfg.if_match.ifm_method == 3 or cfg.tpu.detect_every > 1:
        be = _VmappedStep(cfg, seqs[0].cam)
    else:
        be = JBatchEngine(cfg, seqs[0].cam, batch=B, img_h=H, img_w=W)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    before, after, results = [], [], []
    for n in range(n_frames):
        if edit is not None:
            be.states = edit(n, be.states)
        before.append(to_np(be.states))
        results.append(to_np(be.process_frames(*images(seqs, n))))
        after.append(to_np(be.states))
    cam = StereoCamera.from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         seqs[0].cam))
    return cam, before, after, results


def _counts_near(ours, ref, what):
    """tests/_torch_paths.py's `_check_counts` but the pose."""
    for name in ("detected_feats", "stereo_matches", "valid", "error_code"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      getattr(ref, name), err_msg=what)
    for name in ("tracked_feats_from_last_frame", "tracked_feats_from_last_KF"):
        d = abs(int(getattr(ours, name)) - int(getattr(ref, name)))
        assert d <= TRACK_SLACK, f"{what} {name} differs by {d}"


def _ref_lane(tree, b):
    return jax.tree_util.tree_map(lambda a: a[b], tree)


def check_steps_from_reference(cfg, cam, before, after, results, n_frames):
    """The port's batched step from each reference state against the
    reference's result and next state, lane by lane: equal (integers
    exact, floats at the engine tolerances) where the lane's flat RANSAC
    filter keeps the reference's stage-5 set and tracked count.  Where it
    does not (the port's float32 sums against XLA's, a Sampson-gate or
    hypothesis tie that a lone step meets alike: tests/_torch_paths.py's
    `check_with_ransac`), the lane's counts within that file's bounds and
    the whole lane equal to the port's lone step from the same state
    (integers exact, floats within the batch bounds); its pose is held to
    the lone step's, not to the reference's (with ~14 tracks on this small
    scene one track more moves it by ~0.03).  Returns those (frame,
    lane)."""
    seqs = sequences(n_frames)
    be = tp.BatchEngine(cfg, cam, batch=B, img_h=H, img_w=W, device="cpu")
    alone = make_step(cfg, cam, H, W)
    changed = []
    for n in range(n_frames):
        be.states = state_from_numpy(before[n], device="cpu")
        res = be.process_frames(*images(seqs, n))
        for b in range(B):
            ours, ref = _lane(res, b), _ref_lane(results[n], b)
            what = f"frame {n} lane {b}"
            if (np.array_equal(ours.track_mask.numpy(), ref.track_mask)
                    and int(ours.tracked_feats_from_last_frame)
                    == int(ref.tracked_feats_from_last_frame)):
                _assert_trees_match(ours, ref, what + " StepResult")
                _assert_trees_match(_lane(be.states, b),
                                    _ref_lane(after[n], b), what + " state")
                continue
            changed.append((n, b))
            _counts_near(ours, ref, what)
            state = state_from_numpy(_ref_lane(before[n], b), device="cpu")
            left, right = (torch.from_numpy(x) for x in seqs[b].frames[n])
            _near(alone(state, left, right)[1], ours, what + " lone step")
    return changed


@pytest.fixture(scope="module")
def default_run():
    return reference_batch_run(synthetic_config())


def test_steps_from_the_reference_batch_states(default_run):
    assert check_steps_from_reference(synthetic_config(), *default_run,
                                      N_FRAMES) == []


def test_free_run_equals_the_reference(default_run):
    cam, _, _, results = default_run
    seqs = sequences()
    be = tp.BatchEngine(synthetic_config(), cam, batch=B, img_h=H, img_w=W,
                        device="cpu")
    for n in range(N_FRAMES):
        _assert_trees_match(be.process_frames(*images(seqs, n)), results[n],
                            f"frame {n} StepResult")
    assert be.states.last_pose.shape == (B, 6)


def _lane(tree, b):
    return tree_map(lambda t: t[b], tree)


def _near(lone, lane, what):
    """Integer fields equal; pose within BATCH_POSE_ATOL, residuals and
    cost within BATCH_RES_ATOL (the batched sums, module docstring)."""
    for field, x, y in zip(lone._fields, lone, lane):
        if not x.dtype.is_floating_point:
            assert torch.equal(x, y), f"{what} {field}"
            continue
        atol = BATCH_POSE_ATOL if field == "pose" else BATCH_RES_ATOL
        torch.testing.assert_close(y, x, atol=atol, rtol=0,
                                   msg=f"{what} {field}")


def test_lanes_equal_lone_engines():
    """process_frames for 2 frames, then process_chunk of 2: each lane
    against an Engine that runs its sequence alone; and the chunk equals
    two more process_frames calls of a second BatchEngine bit for bit."""
    seqs = sequences()
    cfg, cam = synthetic_config(), seqs[0].cam
    be = tp.BatchEngine(cfg, cam, batch=B, img_h=H, img_w=W, device="cpu")
    frames = [be.process_frames(*images(seqs, n)) for n in range(2)]
    lefts = np.stack([[f[0] for f in s.frames[2:]] for s in seqs])
    rights = np.stack([[f[1] for f in s.frames[2:]] for s in seqs])
    chunk = be.process_chunk(lefts, rights)
    assert frames[0].pose.shape == (B, 6) and chunk.pose.shape == (2, B, 6)
    for b, s in enumerate(seqs):
        eng = Engine(cfg, cam, device="cpu")
        alone = [eng.process_frame(l, r) for l, r in s.frames]
        batched = frames + [_lane(chunk, n) for n in range(2)]
        for n in range(N_FRAMES):
            _near(alone[n], _lane(batched[n], b), f"sequence {b} frame {n}")
        for x, y in zip(leaves(eng.state), leaves(_lane(be.states, b))):
            if x.dtype.is_floating_point:
                torch.testing.assert_close(y, x, atol=BATCH_POSE_ATOL, rtol=0)
            else:
                assert torch.equal(x, y)

    per_frame = tp.BatchEngine(cfg, cam, batch=B, img_h=H, img_w=W,
                               device="cpu")
    for n in range(N_FRAMES):
        one = per_frame.process_frames(*images(seqs, n))
        want = frames[n] if n < 2 else _lane(chunk, n - 2)
        for field, x, y in zip(one._fields, one, want):
            assert torch.equal(x, y), f"frame {n} {field}"


def test_the_step_runs_once_a_frame_for_all_lanes(monkeypatch):
    """The eager step is called once per frame (inside one vmap), not once
    per lane, and the solver's loop reads one flag a block for all lanes."""
    calls = []
    real = tp.make_step

    def counting(*args, **kw):
        step = real(*args, **kw)

        def run(*a, **k):
            calls.append(a[1].shape)
            return step(*a, **k)
        return run

    monkeypatch.setattr(tp, "make_step", counting)
    seqs = sequences(2)
    be = tp.BatchEngine(synthetic_config(), seqs[0].cam, batch=B, img_h=H,
                        img_w=W, device="cpu")
    robust_gn.HOST_READS.clear()
    for n in range(2):
        be.process_frames(*images(seqs, n))
    assert calls == [(H, W), (H, W)]       # one image a lane inside vmap
    reads = robust_gn.HOST_READS["gn"]
    # at most one read a GN block but the last, per phase and frame
    max_blocks = -(-be.cfg.least_squares.initial_max_iters
                   // robust_gn.GN_BLOCK) + -(-be.cfg.least_squares.max_iters
                                             // robust_gn.GN_BLOCK)
    assert 0 < reads <= 2 * (max_blocks - 2)


def test_any_lane():
    """Outside vmap a copy of the flag; under vmap one flag, true where
    any lane's is, with no lanes' axis (the host reads it)."""
    flag = torch.tensor(True)
    out = robust_gn.any_lane(flag)
    assert bool(out) and out is not flag
    seen = []

    def read(x):
        f = robust_gn.any_lane(x > 0)
        seen.append((tuple(f.shape), bool(f)))
        return x

    torch.func.vmap(read)(torch.tensor([-1.0, 2.0, -3.0]))
    torch.func.vmap(read)(torch.tensor([-1.0, -2.0]))
    assert seen == [((), True), ((), False)]


def test_cho_inverse_rule_equals_the_plain_op():
    """cho_inverse's vmap rule (two batched triangular solves) gives the
    plain op's bits lane by lane on the CPU."""
    g = torch.Generator().manual_seed(3)
    A = torch.randn(5, 30, 6, generator=g) * 40
    L, info = torch.linalg.cholesky_ex(A.mT @ A)
    assert bool((info == 0).all())
    batched = torch.func.vmap(robust_gn.cho_inverse)(L)
    for i in range(5):
        assert torch.equal(batched[i], robust_gn.cho_inverse(L[i]))
    torch.testing.assert_close(batched @ (A.mT @ A),
                               torch.eye(6).expand(5, 6, 6), atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1300])
def test_pairwise_sum(n):
    """Exact on integers; the same bits alone and under vmap."""
    g = torch.Generator().manual_seed(n)
    ints = torch.randint(-50, 50, (3, n), generator=g).float()
    assert torch.equal(t_ransac._pairwise_sum(ints), ints.sum(-1))
    x = torch.randn(4, n, generator=g) * 100
    batched = torch.func.vmap(t_ransac._pairwise_sum)(x)
    for i in range(4):
        assert torch.equal(batched[i], t_ransac._pairwise_sum(x[i]))
