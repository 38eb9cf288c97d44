"""The scene generator: frames are a pure function of the seed, and a lap
closes without a seam."""
import numpy as np
import torch

import _cells
from vobench import drive, gen


def _small(name):
    return _cells.small_cell(name)["cfg"]


def test_frames_are_a_pure_function_of_the_seed():
    cfg = _small("kitti.live")
    cfg["lap"]["frames"] = 24
    a, pa = drive.render_laps(cfg, [2**31 + 5], 0, "cpu")
    b, pb = drive.render_laps(cfg, [2**31 + 5], 0, "cpu")
    c, _ = drive.render_laps(cfg, [2**31 + 6], 0, "cpu")
    np.testing.assert_array_equal(pa, pb)
    assert a.dtype == torch.uint8 and a.shape == (1, 2, 24, 240, 376)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # blobs on a mid-grey field, both eyes
    assert 100 < a.float().mean() < 160 and a.float().std() > 5


def test_lane_seeds():
    t = _cells.small_cell("kitti.fleet", lanes=3)["traffic"]
    assert drive.lane_seeds(t, 2**31 + 1) == [(2**31 + 1) * 100 + b for b in range(3)]
    assert drive.lane_seeds({"lanes": 1}, 5) == [5]


def test_lanes_have_their_own_scenes_and_chunks_never_wrap():
    cfg = _small("kitti.fleet")
    cfg["lap"]["frames"] = 20
    buf, poses = drive.render_laps(cfg, [300, 301], 4, "cpu")
    assert buf.shape == (2, 2, 24, 240, 376) and poses.shape == (2, 20, 4, 4)
    assert not torch.equal(buf[0], buf[1])
    assert torch.equal(buf[:, :, 20:], buf[:, :, :4])


def test_laps_close():
    """The step from a lap's last frame back onto its first is the step
    from its first to its second (the bob of euroc's is a whole number of
    sine cycles)."""
    for name in ("kitti", "euroc"):
        cfg = _cells.json.loads(
            (_cells.ROOT / "vobench" / "configs" / f"{name}.json").read_text())
        P = gen.lap_poses(cfg["lap"])
        assert len(P) == cfg["lap"]["frames"]
        np.testing.assert_allclose(np.linalg.inv(P[-1]) @ P[0],
                                   np.linalg.inv(P[0]) @ P[1], atol=1e-9)
        t = (np.linalg.inv(P[0]) @ P[1])[:3, 3]
        # forward by step_m a frame, the bob aside
        assert abs(np.hypot(t[0], t[2]) - cfg["lap"]["step_m"]) < 1e-3 * cfg["lap"]["step_m"]


def test_the_frame_after_the_lap_is_its_first():
    """Rendered without noise, the pose one step past the last frame gives
    the first frame, pixel for pixel."""
    cfg = _small("kitti.live")
    cfg["scene"]["noise"] = 0.0
    P = gen.lap_poses(cfg["lap"])
    g = torch.Generator().manual_seed(9)
    scene = gen.Scene(cfg["scene"], P, g, "cpu")
    past = P[-1] @ (np.linalg.inv(P[0]) @ P[1])
    H, W = cfg["camera"]["height"], cfg["camera"]["width"]
    eyes = gen.rig(cfg)
    a = gen.render(scene, P[:1], eyes, H, W, g)
    b = gen.render(scene, past[None], eyes, H, W, g)
    assert torch.equal(a, b)
