"""rso_torch parity: config copy, geometry, and the no-jax rule.

The reference (rso, JAX on the CPU) and the port (rso_torch, PyTorch on the
CPU) get the same numpy inputs.  Geometry is float32 math in another
framework, so values agree to float32 rounding: atol 1e-5 on O(1)
quantities, rtol 1e-5 on pixel coordinates (~1000 px).
"""
import dataclasses
import glob
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rso.config as jc
import rso_torch.config as tc
from rso.geometry import rotations as jrot
from rso.geometry import se3 as jse3
from rso.geometry import stereo_camera as jcam
from rso_torch.geometry import rotations as trot
from rso_torch.geometry import se3 as tse3
from rso_torch.geometry import stereo_camera as tcam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM_ARGS = dict(fx_l=718.856, fy_l=718.856, cx_l=607.19, cy_l=185.21,
                baseline=0.5371)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict(cfg):
    """Field-by-field view of a config; enums by value."""
    out = {}
    for sec in dataclasses.fields(cfg):
        sub = getattr(cfg, sec.name)
        for f in dataclasses.fields(sub):
            v = getattr(sub, f.name)
            out[(sec.name, f.name)] = int(v) if isinstance(v, int) else v
    return out


def test_config_defaults_equal():
    assert _cfg_dict(jc.RSOConfig()) == _cfg_dict(tc.RSOConfig())
    assert jc.RSOConfig().n_octaves == tc.RSOConfig().n_octaves


@pytest.mark.parametrize("ini", sorted(glob.glob(os.path.join(REPO, "configs", "*.ini"))),
                         ids=os.path.basename)
def test_config_ini_equal(ini):
    assert _cfg_dict(jc.load_config(ini)) == _cfg_dict(tc.load_config(ini))


def test_config_enums_compare_by_value():
    assert tc.DetectMethod.FASTER == jc.DetectMethod.FASTER
    assert tc.IFMatchMethod.SAD == jc.IFMatchMethod.SAD
    assert [m.name for m in tc.StereoMatchMethod] == [m.name for m in jc.StereoMatchMethod]


def _rotvecs(rng, n=16):
    w = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = [3e-6, -2e-6, 1e-6]          # the small-angle branch
    w[2] = [0.0, 3.1, 0.0]              # near pi
    return w


def test_rodrigues_batched(rng):
    w = _rotvecs(rng)
    ref = np.asarray(jrot.rodrigues(jnp.asarray(w)))
    out = trot.rodrigues(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_rodrigues_with_grad(rng):
    for w in _rotvecs(rng):
        R_j, dR_j = jrot.rodrigues_with_grad(jnp.asarray(w))
        R_t, dR_t = trot.rodrigues_with_grad(torch.from_numpy(w))
        np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-6)
        np.testing.assert_allclose(dR_t.numpy(), np.asarray(dR_j), atol=1e-5)


def test_rotvec_from_matrix_round_trip(rng):
    for w in _rotvecs(rng):
        R = np.asarray(jrot.rodrigues(jnp.asarray(w)))
        ref = np.asarray(jrot.rotvec_from_matrix(jnp.asarray(R)))
        out = trot.rotvec_from_matrix(torch.from_numpy(R.copy())).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5)


def test_se3_ops(rng):
    a = np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, 2, 3)]).astype(np.float32)
    b = np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, 2, 3)]).astype(np.float32)
    pts = rng.normal(0, 5, (20, 3)).astype(np.float32)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(tse3.pose_matrix(ta).numpy(),
                               np.asarray(jse3.pose_matrix(ja)), atol=1e-6)
    np.testing.assert_allclose(tse3.pose_inverse(ta).numpy(),
                               np.asarray(jse3.pose_inverse(ja)), atol=1e-5)
    np.testing.assert_allclose(tse3.pose_compose(ta, tb).numpy(),
                               np.asarray(jse3.pose_compose(ja, jb)), atol=1e-5)
    np.testing.assert_allclose(tse3.pose_apply(ta, torch.from_numpy(pts)).numpy(),
                               np.asarray(jse3.pose_apply(ja, jnp.asarray(pts))),
                               atol=1e-5)


def test_camera_holds_float32_entries():
    jcm = jcam.StereoCamera.make(**CAM_ARGS)
    tcm = tcam.StereoCamera.make(**CAM_ARGS)
    from_np = tcam.StereoCamera.from_numpy(
        type(jcm)(*(np.asarray(v) for v in jcm)))
    for name in tcam.StereoCamera._fields:
        assert getattr(tcm, name).dtype == torch.float32
        assert float(getattr(tcm, name)) == float(getattr(jcm, name))
        assert float(getattr(from_np, name)) == float(getattr(jcm, name))


def _obs(rng, n=64):
    ul = rng.uniform(50, 1200, n).astype(np.float32)
    vl = rng.uniform(20, 360, n).astype(np.float32)
    ur = (ul - rng.uniform(2, 60, n)).astype(np.float32)
    return ul, vl, ur


def test_triangulate_and_project(rng):
    jcm = jcam.StereoCamera.make(**CAM_ARGS)
    tcm = tcam.StereoCamera.make(**CAM_ARGS)
    ul, vl, ur = _obs(rng)
    lj = jcam.triangulate(jcm, jnp.asarray(ul), jnp.asarray(vl), jnp.asarray(ur))
    lt = tcam.triangulate(tcm, torch.from_numpy(ul), torch.from_numpy(vl),
                          torch.from_numpy(ur))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5, atol=1e-5)
    pose = np.asarray([0.01, -0.02, 0.005, 0.05, -0.02, 0.3], np.float32)
    pix_j, J_j = jcam.project_stereo_with_jacobian(jcm, lj, jnp.asarray(pose))
    pix_t, J_t = tcam.project_stereo_with_jacobian(
        tcm, torch.from_numpy(np.array(lj)), torch.from_numpy(pose))
    np.testing.assert_allclose(pix_t.numpy(), np.asarray(pix_j), rtol=1e-5)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), rtol=1e-4, atol=1e-2)
    pl_j = jcam.project_landmarks(jcm, jnp.asarray(ul), jnp.asarray(vl),
                                  jnp.asarray(ur), jnp.asarray(pose))
    pl_t = tcam.project_landmarks(tcm, torch.from_numpy(ul), torch.from_numpy(vl),
                                  torch.from_numpy(ur), torch.from_numpy(pose))
    np.testing.assert_allclose(pl_t.numpy(), np.asarray(pl_j), rtol=1e-5)


def test_port_never_imports_jax():
    """Importing the whole port (engine, kernels, synthetic data) and the
    chip smoke script leaves jax out of sys.modules."""
    code = ("import sys; import rso_torch.engine, rso_torch.kernels, "
            "rso_torch.synthetic, rso_torch.metrics, chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'rso' or m.startswith('rso.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
