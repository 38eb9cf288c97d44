"""The subpixel refine, the optical-flow stage and its tracker against rso
on the CPU.

Inputs: the pyramids of two frames of the seeded test scene
(make_sequence(2000 points, 240x376)), the reference detector's keypoints
and patches on them, and seeded offsets, border positions and invalid
slots.  The reference runs jitted.

Tolerances:
  * `refine_positions`: refined xy within REFINE_ATOL px (XLA contracts the
    bilinear mix and the GN update into FMAs and sums the 8x8 windows in
    another order); which slots move (the det > 1e-6 gate, and with
    `ssd_gate` the SSD test) and the invalid slots' pass-through exact;
  * `_coarse_sad_seed` exact (every SAD is an exact f32 sum), first index on
    ties;
  * `lk_track`: positions within LK_POS_ATOL px and residuals within
    LK_ERR_ATOL (21x21 window sums in another order, FMAs), status exact;
  * `flow_guided_association` exact on coordinates whose squares are exact;
  * `track_optical_flow`: exact without its RANSAC filter; with it, the two
    accepted models agree on >= 90% of the tracks, as
    test_torch_frontend.py::test_track_interframe[True] holds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rso.frontend.optical_flow as jof
import rso.frontend.pyramid as jp
from rso.config import DetectParams as JDP
from rso.frontend.detect import detect_features as j_detect
from rso.frontend.refine import refine_positions as j_refine
from rso.frontend.stereo_match import match_left_right as j_match
from rso.frontend.track import track_optical_flow as j_track_flow
from rso.synthetic import synthetic_config as j_synth_cfg
import rso_torch.frontend.optical_flow as tof
from rso_torch import random as R
from rso_torch.frontend.detect import Features
from rso_torch.frontend.refine import refine_positions as t_refine
from rso_torch.frontend.stereo_match import StereoMatches
from rso_torch.frontend.track import track_optical_flow as t_track_flow
from rso_torch.synthetic import make_sequence, synthetic_config

H, W = 240, 376
K = 128
REFINE_ATOL = 1e-3
LK_POS_ATOL = 2e-3
LK_ERR_ATOL = 1e-3


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
    """Per eye and frame the 3-octave pyramid (numpy), and the reference's
    FASTER features of frame 0's left octave 0 (K slots)."""
    seq = make_sequence(n_frames=2, n_points=2000, H=H, W=W)
    pyr = [[[np.asarray(p) for p in jp.build_pyramid(
        jnp.asarray(seq.frames[f][eye], jnp.float32), 3)] for eye in (0, 1)]
        for f in (0, 1)]
    feats = jax.jit(j_detect, static_argnums=(1, 2, 4))(
        jnp.asarray(pyr[0][0][0]), JDP(), K, jnp.int32(20), False)
    return pyr, jax.tree_util.tree_map(np.asarray, feats)


def _t(a):
    return torch.from_numpy(np.array(a))


def _points(feats, rng, spread):
    """The keypoints moved by seeded offsets in [-spread, spread], with
    border and off-image positions in the last slots and every 7th slot
    invalid."""
    xy = feats.xy + rng.uniform(-spread, spread, feats.xy.shape).astype(np.float32)
    xy[-6:] = [[0.0, 0.0], [W - 1.0, H - 1.0], [-3.2, 50.0], [W + 2.5, 100.3],
               [200.4, -1.7], [10.6, H + 0.4]]
    valid = feats.valid.copy()
    valid[::7] = False
    valid[-6:] = True
    return xy.astype(np.float32), valid


@pytest.mark.parametrize("ssd_gate", [False, True])
@pytest.mark.parametrize("iters", [2, 3])
def test_refine_positions(scene, iters, ssd_gate):
    rng = np.random.default_rng(10 * iters + ssd_gate)
    pyr, feats = scene
    img = pyr[1][0][0]
    xy, valid = _points(feats, rng, 1.5)
    templates = feats.patch.copy()
    templates[3:40:4] = 128.0          # flat: det = 0, the gate refuses them
    templates[5] = np.tile(np.arange(8, dtype=np.float32), 8)   # rank 1
    ref = np.asarray(jax.jit(j_refine, static_argnames=("iters", "ssd_gate"))(
        jnp.asarray(img), jnp.asarray(templates), jnp.asarray(xy),
        jnp.asarray(valid), iters=iters, ssd_gate=ssd_gate))
    out = t_refine(_t(img), _t(templates), _t(xy), _t(valid), iters=iters,
                   ssd_gate=ssd_gate).numpy()
    np.testing.assert_array_equal(out[~valid], xy[~valid])
    # a slot the gate refuses comes back at its clipped start, exactly
    x_clip = np.stack([np.clip(xy[:, 0], 0, W - 1), np.clip(xy[:, 1], 0, H - 1)], 1)
    moved_ref = valid & (ref != x_clip).any(1)
    moved_out = valid & (out != x_clip).any(1)
    np.testing.assert_array_equal(moved_out, moved_ref)
    assert 20 < moved_ref.sum() < valid.sum()
    np.testing.assert_allclose(out, ref, atol=REFINE_ATOL, rtol=0)


@pytest.mark.parametrize("octave", [1, 2])
@pytest.mark.parametrize("seed_range", [4, 12])
def test_coarse_sad_seed_exact(scene, octave, seed_range):
    rng = np.random.default_rng(100 * octave + seed_range)
    pyr, feats = scene
    prev, cur = pyr[0][0][octave], pyr[1][0][octave]
    pts = (_points(feats, rng, 3.0)[0] / 2 ** octave).astype(np.float32)
    ref = jax.jit(jof._coarse_sad_seed, static_argnums=3)(
        jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(pts), seed_range)
    out = tof._coarse_sad_seed(_t(prev), _t(cur), _t(pts), seed_range)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (np.asarray(ref) != 0).any()


def test_coarse_sad_seed_ties_take_the_first_index():
    """A flat search patch: every displacement ties; the first index
    (dy = dx = -range) wins in both."""
    img = np.full((40, 50), 7.0, np.float32)
    pts = np.array([[20.0, 20.0], [1.0, 1.0]], np.float32)
    ref = jof._coarse_sad_seed(jnp.asarray(img), jnp.asarray(img),
                               jnp.asarray(pts), 5)
    out = tof._coarse_sad_seed(_t(img), _t(img), _t(pts), 5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.numpy().tolist() == [[-5, -5], [-5, -5]]


@pytest.mark.parametrize("levels", [1, 3])
def test_lk_track(scene, levels):
    rng = np.random.default_rng(levels)
    pyr, feats = scene
    pts, valid = _points(feats, rng, 0.0)
    lk = jax.jit(jof.lk_track)
    ref = lk([jnp.asarray(p) for p in pyr[0][0][:levels]],
             [jnp.asarray(p) for p in pyr[1][0][:levels]],
             jnp.asarray(pts), jnp.asarray(valid))
    out = tof.lk_track([_t(p) for p in pyr[0][0][:levels]],
                       [_t(p) for p in pyr[1][0][:levels]], _t(pts), _t(valid))
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    assert out.status.sum() > 40
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(ref.pos),
                               atol=LK_POS_ATOL, rtol=0)
    np.testing.assert_allclose(out.err.numpy(), np.asarray(ref.err),
                               atol=LK_ERR_ATOL, rtol=0)


def test_flow_guided_association_exact():
    rng = np.random.default_rng(5)
    n = 96
    # coordinates on a 1/8 grid: every squared distance is exact
    pred = (rng.integers(0, 200 * 8, (n, 2)) / 8).astype(np.float32)
    cur = (pred + rng.integers(-40, 40, (n, 2)) / 8).astype(np.float32)
    cur[10:20] = cur[0:10]                          # ties: first index wins
    cur = cur[rng.permutation(n)]
    pred_ok = rng.random(n) > 0.1
    cur_ok = rng.random(n) > 0.1
    ref = jof.flow_guided_association(jnp.asarray(pred), jnp.asarray(pred_ok),
                                      jnp.asarray(cur), jnp.asarray(cur_ok))
    out = tof.flow_guided_association(_t(pred), _t(pred_ok), _t(cur), _t(cur_ok))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert 20 < int(out[1].sum()) < n


def _matched(pyr_f, o=0):
    """Reference FASTER features (both eyes) and SAD stereo matches."""
    det = jax.jit(j_detect, static_argnums=(1, 2, 4))
    fl = det(jnp.asarray(pyr_f[0][o]), JDP(), K, jnp.int32(20), False)
    fr = det(jnp.asarray(pyr_f[1][o]), JDP(), K, jnp.int32(20), False)
    fxb = float(np.float32(320.0)) * float(np.float32(0.4)) / 2 ** o
    m = jax.jit(lambda a, b: j_match(a, b, j_synth_cfg().lr_match, W >> o, 0.0,
                                     fx_baseline=fxb, use_fused=False))(fl, fr)
    return fl, fr, m


def _feats_t(f):
    return Features(*(_t(np.asarray(v).view(np.int32) if np.asarray(v).dtype
                         == np.uint32 else v) for v in f))


@pytest.mark.parametrize("octave", [0, 1])
@pytest.mark.parametrize("filter_fund", [False, True])
def test_track_optical_flow(scene, filter_fund, octave):
    pyr, _ = scene
    prev, cur = _matched(pyr[0], octave), _matched(pyr[1], octave)
    ifm = dataclasses.replace(j_synth_cfg().if_match, ifm_method=3,
                              filter_fund_matrix=filter_fund)
    sub = lambda f, eye: [jnp.asarray(p) for p in pyr[f][eye][octave:]]  # noqa: E731
    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    ref = j_track_flow(sub(0, 0), sub(0, 1), sub(1, 0), sub(1, 1), *prev, *cur,
                       ifm, key, ransac_iters=256)
    t_ifm = dataclasses.replace(synthetic_config().if_match, ifm_method=3,
                                filter_fund_matrix=filter_fund)
    tsub = lambda f, eye: [_t(p) for p in pyr[f][eye][octave:]]  # noqa: E731
    conv = lambda fl, fr, m: (_feats_t(fl), _feats_t(fr),  # noqa: E731
                              StereoMatches(*(_t(v) for v in m)))
    out = t_track_flow(tsub(0, 0), tsub(0, 1), tsub(1, 0), tsub(1, 1),
                       *conv(*prev), *conv(*cur), t_ifm,
                       R.fold_in(R.PRNGKey(7), 3), ransac_iters=256)
    v_ref, v_out = np.asarray(ref.valid), out.valid.numpy()
    both = v_ref & v_out
    np.testing.assert_array_equal(out.cur_idx.numpy()[both],
                                  np.asarray(ref.cur_idx)[both])
    assert both.sum() > 15
    if not filter_fund:
        np.testing.assert_array_equal(v_out, v_ref)
    else:
        # the per-octave RANSAC's f32 null vectors at a condition number
        # near 3e6: among near-tied hypotheses the best one can change
        assert (v_ref != v_out).sum() <= 0.1 * max(v_ref.sum(), 1)
