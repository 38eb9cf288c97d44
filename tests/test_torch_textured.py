"""The textured corridor against rso on the CPU: its renderer, its
configuration and the engine on it.

The renderer is host numpy copied from rso/synthetic.py: the same texture,
frames and poses bit for bit.  Both modules' `_REFERENCE_TEXTURE` point at
a missing file here, so both take the procedural texture.  The engine path
runs textured_config() over 4 frames of make_textured_sequence at 240x376,
one port step from each reference state, at the tolerances of
tests/_torch_paths.py (integers and masks exact; keypoint xy 1e-3 px,
poses 1e-5, residuals and cost 5e-3).
"""
import numpy as np
import pytest
import torch

import _torch_paths as P
import rso.synthetic as js
import rso_torch.synthetic as ts
from test_torch_geometry import _cfg_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def procedural(monkeypatch, tmp_path):
    """Both packages' optional texture file made certain to be absent."""
    missing = str(tmp_path / "absent.png")
    monkeypatch.setattr(js, "_REFERENCE_TEXTURE", missing)
    monkeypatch.setattr(ts, "_REFERENCE_TEXTURE", missing)


@pytest.mark.parametrize("size, seed", [(512, 0), (200, 3)])
def test_default_texture_equal(procedural, size, seed):
    ref = js.default_texture(size=size, seed=seed)
    out = ts.default_texture(size=size, seed=seed)
    assert out.dtype == np.uint8 and out.shape == (size, size)
    np.testing.assert_array_equal(out, ref)


def test_make_textured_sequence_equal(procedural):
    """3 frames at 240x376: u8 frames, poses and camera bit for bit."""
    ref = js.make_textured_sequence(n_frames=3, H=240, W=376)
    out = ts.make_textured_sequence(n_frames=3, H=240, W=376)
    assert len(out.frames) == 3
    for (al, ar), (bl, br) in zip(out.frames, ref.frames):
        assert al.dtype == np.uint8 and al.shape == (240, 376)
        np.testing.assert_array_equal(al, bl)
        np.testing.assert_array_equal(ar, br)
    np.testing.assert_array_equal(out.poses, ref.poses)
    np.testing.assert_array_equal(out.rel_poses, ref.rel_poses)
    for name in ("fx_l", "fy_l", "cx_l", "cy_l", "baseline"):
        assert float(getattr(out.cam, name)) == float(getattr(ref.cam, name))


def test_textured_config_equal():
    assert _cfg_dict(ts.textured_config()) == _cfg_dict(js.textured_config())


@pytest.mark.parametrize("frame", range(P.N_FRAMES))
def test_textured_step_without_the_ransac_filter(frame):
    P.check_exact("textured", frame)


def test_textured_steps_with_the_ransac_filter():
    assert P.check_with_ransac("textured") <= 1
