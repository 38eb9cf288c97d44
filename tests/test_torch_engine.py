"""The port's engine step against the reference engine, on the CPU.

One module-scoped reference run: rso's Engine over make_sequence(4 frames,
2000 points, 240x376) with use_mxu_distance=False (the dense exact-SAD
path: the fused kernels' semantics; the default MXU shortlist is a
TPU-only approximation).  The port then starts from each reference state
(state_from_numpy), steps one frame, and is compared field by field: the
StepResult and the next state.  A second run keeps the port's own state for
all 4 frames.

Tolerances: integer and bool fields exact (counts, error codes, iteration
counts, IDs, masks, match indices).  Float fields: keypoint xy atol 1e-3 px
and responses rtol 1e-5 (XLA's CPU backend contracts two multiply-adds in
the corner response into FMAs); pose and last_pose atol 1e-5; squared
residuals and cost atol 5e-3 (projections of ~400 px in float32).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rso.engine import Engine as JEngine, init_state as j_init_state
from rso.synthetic import make_sequence as j_make_sequence
from rso.synthetic import synthetic_config as j_synthetic_config
import rso_torch.engine as te
from rso_torch.geometry import StereoCamera
from rso_torch.solver.robust_gn import VOEC_FIRST_ITERATION
from rso_torch.synthetic import make_sequence, synthetic_config

H, W = 240, 376
N_FRAMES = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    """{path: numpy array} over a NamedTuple/tuple tree."""
    if hasattr(tree, "_fields"):
        out = {}
        for name, v in zip(tree._fields, tree):
            out.update(_flat(v, f"{prefix}.{name}"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    a = tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return {prefix: a.view(np.int32) if a.dtype == np.uint32 else a}


def _tol(path):
    """(atol, rtol) for a float field, by name."""
    if path.endswith(".xy"):
        return 1e-3, 0.0
    if path.endswith(".response"):
        return 1e-3, 1e-5
    if path.endswith(("residuals", "cost")):
        return 5e-3, 1e-5
    return 1e-5, 0.0           # poses, match distances, patches, weights


def _assert_trees_match(ours, ref, what):
    a, b = _flat(ours), _flat(ref)
    assert a.keys() == b.keys(), what
    for path in a:
        x, y = a[path], b[path]
        assert x.shape == y.shape, f"{what}{path}: shape {x.shape} vs {y.shape}"
        if x.dtype.kind in "biu":
            np.testing.assert_array_equal(x, y.astype(x.dtype),
                                          err_msg=f"{what}{path}")
        else:
            atol, rtol = _tol(path)
            np.testing.assert_allclose(x, y, atol=atol, rtol=rtol,
                                       err_msg=f"{what}{path}")


@pytest.fixture(scope="module")
def reference_run():
    """The reference engine over the test scene: states before/after every
    frame and every StepResult, as numpy trees."""
    seq = j_make_sequence(n_frames=N_FRAMES, n_points=2000)
    cfg = j_synthetic_config()
    cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, use_mxu_distance=False))
    eng = JEngine(cfg, seq.cam)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    states = [to_np(j_init_state(cfg, (H, W)))]
    results = []
    for left, right in seq.frames:
        results.append(to_np(eng.process_frame(left, right)))
        states.append(to_np(eng.state))
    return seq, states, results


@pytest.fixture(scope="module")
def port_step(reference_run):
    seq = reference_run[0]
    cam = StereoCamera.from_numpy(jax.tree_util.tree_map(np.asarray, seq.cam))
    return te.make_step(synthetic_config(), cam, H, W)


def test_same_frames_as_reference(reference_run):
    ours = make_sequence(n_frames=N_FRAMES, n_points=2000)
    for (l0, r0), (l1, r1) in zip(reference_run[0].frames, ours.frames):
        np.testing.assert_array_equal(l0, l1)
        np.testing.assert_array_equal(r0, r1)
    np.testing.assert_array_equal(reference_run[0].poses, ours.poses)


def test_init_state_matches_reference(reference_run):
    _assert_trees_match(te.init_state(synthetic_config(), (H, W), device="cpu"),
                        reference_run[1][0], "init_state")


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_step_from_reference_state(reference_run, port_step, frame):
    seq, states, results = reference_run
    state = te.state_from_numpy(states[frame], device="cpu")
    left, right = seq.frames[frame]
    new_state, result = port_step(state, torch.from_numpy(left),
                                  torch.from_numpy(right))
    _assert_trees_match(result, results[frame], f"frame {frame} StepResult")
    _assert_trees_match(new_state, states[frame + 1], f"frame {frame} state")


def test_four_frames_with_the_ports_own_state(reference_run):
    seq, _, results = reference_run
    eng = te.Engine(synthetic_config(), seq.cam, device="cpu")
    ours = [eng.process_frame(l, r) for l, r in seq.frames]
    assert int(ours[0].error_code) == VOEC_FIRST_ITERATION
    assert all(bool(r.valid) for r in ours[1:])
    for i, (o, r) in enumerate(zip(ours, results)):
        _assert_trees_match(o, r, f"frame {i} StepResult")


def test_process_chunk_equals_frame_loop(reference_run):
    seq = reference_run[0]
    lefts = np.stack([l for l, _ in seq.frames[:3]])
    rights = np.stack([r for _, r in seq.frames[:3]])
    chunk = te.Engine(synthetic_config(), seq.cam,
                      device="cpu").process_chunk(lefts, rights)
    eng = te.Engine(synthetic_config(), seq.cam, device="cpu")
    for i in range(3):
        one = eng.process_frame(lefts[i], rights[i])
        for name, a, b in zip(one._fields, one, chunk):
            assert torch.equal(a, b[i]), name


def test_repeat_reruns_against_the_same_previous_frame(reference_run):
    seq = reference_run[0]
    eng = te.Engine(synthetic_config(), seq.cam, device="cpu")
    eng.process_frame(*seq.frames[0])
    first = eng.process_frame(*seq.frames[1])
    again = eng.process_frame(*seq.frames[1], repeat=True)
    assert torch.equal(first.pose, again.pose)
    assert int(eng.state.frame_idx) == 2


def test_state_from_numpy_types(reference_run):
    state = te.state_from_numpy(reference_run[1][2], device="cpu")
    ref = te.init_state(synthetic_config(), (H, W), device="cpu")
    a, b = _flat(state), _flat(ref)
    for path in a:
        assert a[path].dtype == b[path].dtype and a[path].shape == b[path].shape, path


def test_cuda_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cam = StereoCamera.make(fx_l=320.0, fy_l=320.0, cx_l=188.0, cy_l=120.0,
                            baseline=0.4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.Engine(synthetic_config(), cam, device="cuda")


def test_entry_points_default_to_the_gpu(reference_run):
    """With no device the entry points ask for CUDA: here, where there is
    none, each raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cam = StereoCamera.make(fx_l=320.0, fy_l=320.0, cx_l=188.0, cy_l=120.0,
                            baseline=0.4)
    for call in (lambda: te.Engine(synthetic_config(), cam),
                 lambda: te.init_state(synthetic_config(), (H, W)),
                 lambda: te.state_from_numpy(reference_run[1][1])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_no_module_loads_jax_or_rso():
    """Every module of the package, imported in a fresh interpreter."""
    code = ("import pkgutil, importlib, sys, rso_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(rso_torch.__path__, "
            "'rso_torch.')]\n"
            "for n in names: importlib.import_module(n)\n"
            "assert len(names) >= 30, names\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'rso')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_engine_module_leaves_jax_unloaded():
    code = "import sys, rso_torch.engine; assert 'jax' not in sys.modules"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
