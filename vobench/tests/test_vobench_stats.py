"""The end-to-end arithmetic and the roofline counts."""
import math

import numpy as np
import pytest

import _cells  # noqa: F401  (puts the repository on the path)
from vobench import roofline, stats


def test_percentile_is_nearest_rank_over_all_values():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(list(range(1, 21)), 95) == 19
    # one stall among 100 frames sits above the 95th percentile; six do not
    assert stats.percentile([10.0] * 99 + [500.0], 95) == 10.0
    assert stats.percentile([10.0] * 94 + [500.0] * 6, 95) == 500.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_is_total_over_window():
    assert stats.rate(2320, 20.0) == 116.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_pose_matrix():
    step = stats.pose_matrix([0.0, 0.1, 0.0, 0.0, 0.0, 1.0])
    np.testing.assert_allclose(step[:3, :3] @ step[:3, :3].T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(step[:3, 3], [0.0, 0.0, 1.0])
    np.testing.assert_allclose(step[0, 2], np.sin(0.1), atol=1e-15)


def test_roofline_counts_match_the_published_bounds():
    """chip_smoke.py's bounds at the KITTI shape: kernel 1 1.32 us
    (operations), kernel 2 0.083 us, kernel 3 0.16 us, kernel 4 0.055 us
    (bytes)."""
    assert roofline.corner_ops(4) == 190
    assert roofline.octave_slots(500, 3) == [512, 256, 128]
    assert roofline.octave_slots(600, 3) == [512, 384, 128]
    f = roofline.frame_launches(376, 1241, 500, 3)
    assert [len(f[k]) for k in ("corner_response_kernel", "stereo_sad_kernel",
                                "track_sad_kernel", "nullvec9_kernel")] == [6, 3, 3, 2]
    assert f["corner_response_kernel"][0] * 1e6 == pytest.approx(1.3232, abs=1e-4)
    assert f["stereo_sad_kernel"][0] * 1e6 == pytest.approx(0.0828, abs=1e-4)
    assert f["track_sad_kernel"][0] * 1e6 == pytest.approx(0.1617, abs=1e-4)
    assert f["nullvec9_kernel"][0] * 1e6 == pytest.approx(0.0550, abs=1e-4)
    f11 = roofline.frame_launches(376, 1241, 500, 3, lanes=11)
    assert f11["stereo_sad_kernel"][2] == pytest.approx(11 * f["stereo_sad_kernel"][2])
    assert math.isclose(roofline.least_s(67e12, 0), 1.0)


def test_ini_shapes_of_the_frozen_presets():
    from pathlib import Path
    d = Path(_cells.ROOT) / "vobench" / "configs"
    assert roofline.ini_shapes(str(d / "kitti.ini")) == {"nfeats": 500, "n_octaves": 3}
    assert roofline.ini_shapes(str(d / "euroc.ini")) == {"nfeats": 600, "n_octaves": 3}


def test_pose_gap_holds_valid_and_leaves_out_the_widest_two_percent():
    from vobench import judge, refvo

    cam = refvo.Camera(500.0, 500.0, 0.0, 0.0, 0.5)
    pts = np.array([[0.0, 0.0, 10.0], [1.0, 0.5, 8.0], [-1.0, 0.2, 12.0]])
    ok = refvo.Step(np.eye(4), True, pts, 3)
    moved = np.eye(4)
    moved[0, 3] = 0.01                        # 0.5 px at 10 m
    gap = refvo.pose_gap_px(moved, np.eye(4), pts, cam)
    assert gap == pytest.approx(0.5)
    # 100 frames: one lost, one far off; both among the widest 2%
    far = moved.copy()
    far[0, 3] = 1.0
    got = judge.compare([moved] * 98 + [None, far], [ok] * 100, cam)
    assert got["judged"] == 100 and got["lost"] == 1
    assert got["pose_gap_px"] == pytest.approx(0.5)
    # every second frame lost: the mean follows the lost frames
    half = judge.compare([moved, None] * 50, [ok] * 100, cam)
    assert half["pose_gap_px"] > 1.0
    # frames the reference cannot judge are left out, but not most of them
    bad = refvo.Step(np.eye(4), False, pts, 3)
    assert judge.compare([moved] * 2, [ok, bad], cam)["pose_gap_px"] \
        == pytest.approx(0.5)
    assert judge.compare([moved] * 3, [ok, bad, bad], cam)["pose_gap_px"] \
        == float("inf")
