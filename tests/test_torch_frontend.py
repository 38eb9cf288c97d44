"""rso_torch frontend (stages 1-4) against rso on the CPU.

The reference runs jitted, with its fused Pallas stage-3/4 kernels in
interpret mode (`interpret_pallas=True`); off the TPU its default would take
the approximate MXU shortlist instead, which is not the fused kernels'
semantics.  Inputs come from the seeded synthetic generator.

Tolerances: FAST masks, NMS masks, top-K slots, validity, patches, match
and track indices exact.  Corner responses rtol 1e-5 (XLA's CPU backend
contracts two multiply-adds into FMAs), and through the subpixel parabola
keypoint xy atol 1e-3 px.  The optional per-octave RANSAC filter of the
tracker (off in the engine) agrees on >= 90% of the tracks; see the test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rso.frontend.detect as jd
import rso.frontend.pyramid as jp
from rso.config import DetectParams as JDP
from rso.frontend.stereo_match import match_left_right as j_match
from rso.frontend.track import track_interframe as j_track
from rso.synthetic import synthetic_config as j_synth_cfg
import rso_torch.frontend.detect as td
import rso_torch.frontend.pyramid as tp
from rso_torch import random as R
from rso_torch.config import DetectMethod, DetectParams as TDP
from rso_torch.frontend.detect import Features
from rso_torch.frontend.stereo_match import StereoMatches, match_left_right as t_match
from rso_torch.frontend.track import track_interframe as t_track
from rso_torch.synthetic import make_sequence, synthetic_config

H, W = 240, 376
K0 = 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    seq = make_sequence(n_frames=2, n_points=2000, H=H, W=W)
    return [(l.astype(np.float32), r.astype(np.float32)) for l, r in seq.frames]


def _t(a):
    return torch.from_numpy(np.array(a))


def _feats_t(f) -> Features:
    return Features(*(_t(np.asarray(v).view(np.int32) if np.asarray(v).dtype == np.uint32
                         else v) for v in f))


@pytest.mark.parametrize("shape", [(240, 376), (121, 375)])
def test_pyramid_exact(shape, rng):
    img = rng.integers(0, 256, shape).astype(np.uint8)
    ref = jax.jit(lambda x: jp.build_pyramid(jp.to_grayscale(x), 3))(jnp.asarray(img))
    out = tp.build_pyramid(tp.to_grayscale(_t(img)), 3)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_grayscale_rgb(rng):
    img = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    np.testing.assert_allclose(tp.to_grayscale(_t(img)).numpy(),
                               np.asarray(jp.to_grayscale(jnp.asarray(img))),
                               rtol=1e-6)


@pytest.mark.parametrize("th", [10, 20, 30])
def test_fast_corner_mask_exact(frames, th):
    img = frames[0][0]
    ref = jax.jit(jd.fast_corner_mask, static_argnames="arc")(
        jnp.asarray(img), jnp.int32(th))
    out = td.fast_corner_mask(_t(img), torch.tensor(th, dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.sum() > 100


def test_shi_tomasi_response(frames):
    img = frames[0][0]
    ref = np.asarray(jax.jit(jd.shi_tomasi_response, static_argnums=1)(
        jnp.asarray(img), 4))
    out = td.shi_tomasi_response(_t(img), 4).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-3)


def test_nms_grid_exact(frames):
    from rso.kernels.fast_detect import corner_response_jnp

    resp = np.asarray(corner_response_jnp(jnp.asarray(frames[0][0]), 20))
    for radius in (1, 3, 5):
        ref = np.asarray(jd.nms_grid(jnp.asarray(resp), radius))
        out = td.nms_grid(_t(resp), radius).numpy()
        np.testing.assert_array_equal(out, ref)


def test_select_topk_orders_ties_by_index():
    """Equal responses: value descending, then lowest flat index first
    (torch.topk promises no order among ties)."""
    resp = np.full((6, 7), -np.inf, np.float32)
    for (y, x) in [(1, 5), (4, 1), (2, 2), (5, 6), (3, 3)]:
        resp[y, x] = 7.0
    resp[0, 0] = 9.0
    keep = np.isfinite(resp)
    xy_j, r_j, v_j = jd.select_topk(jnp.asarray(resp), jnp.asarray(keep), 4,
                                    subpixel=False)
    xy_t, r_t, v_t = td.select_topk(_t(resp), _t(keep), 4, subpixel=False)
    np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert xy_t.numpy().tolist() == [[0, 0], [5, 1], [2, 2], [3, 3]]


def test_extract_patches_exact(frames, rng):
    img = frames[0][0]
    xy = np.stack([rng.uniform(-2, W + 2, 64), rng.uniform(-2, H + 2, 64)],
                  -1).astype(np.float32)
    ref = jd.extract_patches(jnp.asarray(img), jnp.asarray(xy))
    np.testing.assert_array_equal(td.extract_patches(_t(img), _t(xy)).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("nfeats,octaves,kmax,decay",
                         [(500, 3, 512, True), (500, 3, 512, False),
                          (2000, 4, 1024, True), (300, 1, 512, True)])
def test_octave_budgets(nfeats, octaves, kmax, decay):
    assert td.octave_budget(nfeats, octaves) == jd.octave_budget(nfeats, octaves)
    assert (td.octave_k_slots(nfeats, octaves, kmax, decay)
            == jd.octave_k_slots(nfeats, octaves, kmax, decay))


@pytest.mark.parametrize("n_feats", [10, 900, 5000])
def test_update_fast_threshold(n_feats):
    ref = jd.update_fast_threshold(jnp.int32(20), jnp.int32(n_feats), H * W, JDP())
    out = td.update_fast_threshold(torch.tensor(20, dtype=torch.int32),
                                   torch.tensor(n_feats), H * W, TDP())
    assert int(out) == int(ref)


def _detect_both(img, k, th=20):
    fj = jax.jit(jd.detect_features, static_argnums=(1, 2, 4))(
        jnp.asarray(img), JDP(), k, jnp.int32(th), False)
    ft = td.detect_features(_t(img), TDP(), k,
                            torch.tensor(th, dtype=torch.int32), False)
    return fj, ft


@pytest.mark.parametrize("octave", [0, 1, 2])
def test_detect_features(frames, octave):
    img = np.asarray(jp.build_pyramid(jnp.asarray(frames[0][0]), 3)[octave])
    k = td.octave_k_slots(500, 3, K0)[octave]
    fj, ft = _detect_both(img, k)
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    np.testing.assert_array_equal(ft.patch.numpy(), np.asarray(fj.patch))
    np.testing.assert_allclose(ft.xy.numpy(), np.asarray(fj.xy), atol=1e-3)
    np.testing.assert_allclose(ft.response.numpy(), np.asarray(fj.response),
                               rtol=1e-5, atol=1e-3)
    assert ft.valid.sum() > 50


def _reference_cfg():
    cfg = j_synth_cfg()
    return cfg.replace(tpu=dataclasses.replace(cfg.tpu, interpret_pallas=True))


def _matched_frame(frame, k=K0):
    """Reference features and stereo matches of one frame (octave 0)."""
    cfg = _reference_cfg()
    fl, _ = _detect_both(frame[0], k)
    fr, _ = _detect_both(frame[1], k)
    fxb = float(np.float32(320.0)) * float(np.float32(0.4))
    m = jax.jit(lambda a, b: j_match(a, b, cfg.lr_match, W, 0.0, fx_baseline=fxb,
                                     use_fused=True, interpret_pallas=True))(fl, fr)
    return fl, fr, m, fxb


@pytest.mark.parametrize("robust", [True, False])
def test_match_left_right(frames, robust):
    cfg = _reference_cfg()
    lr = dataclasses.replace(cfg.lr_match, enable_robust_1to1_match=robust)
    fl, fr, _, fxb = _matched_frame(frames[0])
    ref = jax.jit(lambda a, b: j_match(a, b, lr, W, 0.0, fx_baseline=fxb,
                                       use_fused=True, interpret_pallas=True))(fl, fr)
    t_lr = dataclasses.replace(synthetic_config().lr_match,
                               enable_robust_1to1_match=robust)
    out = t_match(_feats_t(fl), _feats_t(fr), t_lr, W, 0.0, fx_baseline=fxb)
    for name in StereoMatches._fields:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert out.valid.sum() > 50


@pytest.mark.parametrize("filter_fund", [False, True])
def test_track_interframe(frames, filter_fund):
    cfg = _reference_cfg()
    ifm = dataclasses.replace(cfg.if_match, filter_fund_matrix=filter_fund)
    prev = _matched_frame(frames[0])[:3]
    cur = _matched_frame(frames[1])[:3]
    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    ref = j_track(*prev, *cur, ifm, key, ransac_iters=256,
                  use_fused=True, interpret_pallas=True)
    t_ifm = dataclasses.replace(synthetic_config().if_match,
                                filter_fund_matrix=filter_fund)
    conv = lambda fl, fr, m: (_feats_t(fl), _feats_t(fr),  # noqa: E731
                              StereoMatches(*(_t(v) for v in m)))
    out = t_track(*conv(*prev), *conv(*cur), t_ifm, R.fold_in(R.PRNGKey(7), 3),
                  ransac_iters=256)
    v_ref, v_out = np.asarray(ref.valid), out.valid.numpy()
    both = v_ref & v_out
    np.testing.assert_array_equal(out.cur_idx.numpy()[both],
                                  np.asarray(ref.cur_idx)[both])
    assert both.sum() > 20
    if not filter_fund:
        np.testing.assert_array_equal(v_out, v_ref)
    else:
        # The 8-point null vector is solved in float32 at a condition number
        # near 3e6, so last-bit differences in A^T A (another matmul order)
        # move hypothesis models by up to ~0.4% and flip a few 1-px Sampson
        # decisions; among near-tied hypotheses the best one can change (here
        # 4 of 74 tracks differ).  The two accepted models must agree on at
        # least 90% of the tracks.
        assert (v_ref != v_out).sum() <= 0.1 * max(v_ref.sum(), 1)


def test_unported_methods_raise(frames):
    img = _t(frames[0][0])
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #13"):
        td.detect_features(img, TDP(detect_method=DetectMethod.KLT), 128, 20, False)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #13"):
        td.detect_features(img, TDP(), 128, 20, True)
