"""The port's pyramidal LK (`optical_flow.lk_track`, its plain version on the
CPU) against the plain float64 tracker of the benchmark,
vobench/reflk.py, which imports nothing of the program.

Inputs: the pyramids of two frames of the seeded test scene
(make_sequence(2000 points, 240x376)), FASTER keypoints of frame 0 moved by
seeded offsets on a 1/16 px grid (so that a keypoint's rounding to the
seed's window centre is the same in f32 and f64), border, off-image and
invalid slots.

Tolerances, the port (f32) against the reference (f64):
  * positions within POS_ATOL px where both track the keypoint: the port
    sums each 441-pixel window in f32, ten steps a level (measured 4e-5 px
    at 240x376); 2e-3 px is ROADMAP's bound of the port against rso;
  * the final mean absolute residual within ERR_ATOL (grey levels 0-255,
    f32 sums of 441 terms; measured 1.1e-4);
  * status exact, and the coarse SAD seed exact (every SAD is an exact sum
    in both).
The same tracker computed in float16 or bfloat16 fails them: bfloat16's
positions move by ~0.4 px (its 8-bit mantissa spaces grey levels by up to
1 and coordinates past 256 by 2), float16's structure tensors overflow and
its statuses part.
"""
import numpy as np
import pytest
import torch

from rso_torch.config import DetectParams
from rso_torch.frontend import optical_flow as OF
from rso_torch.frontend.detect import detect_features
from rso_torch.frontend.pyramid import build_pyramid, to_grayscale
from rso_torch.synthetic import make_sequence
from vobench import reflk

H, W = 240, 376
K = 128
POS_ATOL = 2e-3
ERR_ATOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """Per frame and eye the 3-level pyramid, and FASTER keypoints of frame
    0's left image (K slots, their valid flags)."""
    seq = make_sequence(n_frames=2, n_points=2000, H=H, W=W)
    pyr = [[build_pyramid(to_grayscale(torch.from_numpy(seq.frames[f][e])), 3)
            for e in (0, 1)] for f in (0, 1)]
    feats = detect_features(pyr[0][0][0], DetectParams(), K,
                            torch.tensor(20, dtype=torch.int32), False)
    return pyr, feats


def _points(feats, seed: int, spread: float):
    """The keypoints moved by offsets on a 1/16 px grid in [-spread,
    spread], the last slots at the border and off the image, every 7th slot
    invalid."""
    rng = np.random.default_rng(seed)
    off = np.round(rng.uniform(-spread, spread, (K, 2)) * 16) / 16
    xy = feats.xy.numpy() + off
    xy[-6:] = [[0.0, 0.0], [W - 1.0, H - 1.0], [-3.25, 50.0], [W + 2.5, 100.25],
               [200.5, -1.75], [10.625, H + 0.5]]
    valid = feats.valid.clone()
    valid[::7] = False
    valid[-6:] = True
    return torch.tensor(xy, dtype=torch.float32), valid


@pytest.mark.parametrize("spread", [0.0, 3.0])
@pytest.mark.parametrize("levels", [1, 2, 3])
def test_lk_track_against_the_reference(scene, levels, spread):
    pyr, feats = scene
    pts, valid = _points(feats, levels, spread)
    prev, cur = pyr[0][0][:levels], pyr[1][0][:levels]
    out = OF.lk_track(prev, cur, pts, valid)
    pos, status, err = reflk.track(prev, cur, pts, valid)
    np.testing.assert_array_equal(out.status.numpy(), status.numpy())
    assert 80 < int(status.sum()) < K
    both = status.numpy()
    np.testing.assert_allclose(out.pos.double().numpy()[both],
                               pos.numpy()[both], atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(out.err.double().numpy()[both],
                               err.numpy()[both], atol=ERR_ATOL, rtol=0)


@pytest.mark.parametrize("octave", [0, 1, 2])
def test_the_seed_is_the_reference_s(scene, octave):
    """The coarse SAD seed exactly: the same displacement for every slot,
    borders and off-image slots included."""
    pyr, feats = scene
    pts = _points(feats, 10 + octave, 3.0)[0] / 2 ** octave
    prev, cur = pyr[0][0][octave], pyr[1][0][octave]
    got = OF._coarse_sad_seed(prev, cur, pts, 12)
    want = reflk.seed(prev.double(), cur.double(), pts.double(), 12)
    np.testing.assert_array_equal(got.double().numpy(), want.numpy())
    assert (want != 0).any()


def test_the_seed_takes_the_first_displacement_on_ties():
    img = torch.full((40, 50), 7.0)
    pts = torch.tensor([[20.0, 20.0], [1.0, 1.0]])
    want = reflk.seed(img.double(), img.double(), pts.double(), 5)
    assert want.tolist() == [[-5, -5], [-5, -5]]
    assert OF._coarse_sad_seed(img, img, pts, 5).tolist() == want.tolist()


def test_both_eyes_at_once_are_each_eye_alone(scene):
    """lk_track_eyes, which stacks a stereo pair's eyes into one call, gives
    each eye's lk_track bit for bit."""
    pyr, feats = scene
    pts = torch.stack([_points(feats, 20 + e, 2.0)[0] for e in (0, 1)])
    valid = torch.stack([_points(feats, 20 + e, 2.0)[1] for e in (0, 1)])
    both = OF.lk_track_eyes(pyr[0], pyr[1], pts, valid)
    for e in (0, 1):
        alone = OF.lk_track(pyr[0][e], pyr[1][e], pts[e], valid[e])
        for a, b in zip(both, alone):
            assert torch.equal(a[e], b)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_a_lower_precision_lk_fails_the_tolerances(scene, dtype):
    """The reference computed in `dtype` in the port's place: its statuses
    part from float64's, or its positions leave POS_ATOL."""
    pyr, feats = scene
    pts, valid = _points(feats, 3, 3.0)
    pos, status, _ = reflk.track(pyr[0][0], pyr[1][0], pts, valid)
    low_pos, low_status, _ = reflk.track(pyr[0][0], pyr[1][0], pts, valid,
                                         dtype=dtype)
    both = status & low_status
    gap = (low_pos.double() - pos).abs().amax(1)[both]
    assert (not torch.equal(status, low_status)
            or float(gap.max()) > 100 * POS_ATOL)
