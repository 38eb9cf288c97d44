"""rso_torch detectors, descriptors and adaptive NMS against rso, on the CPU.

The reference runs jitted on the CPU; inputs are the blob scene of
tests/test_modes.py (make_sequence, 4 frames, 1800 points, 160x240) and
seeded random patches.

Tolerances, with their reasons:
  * the learned pattern, packed descriptor bits, upright descriptors, the
    intensity-centroid moments' input patches, SAD patches, validity and
    adaptive-NMS masks: exact.  Upright samples sit on integer offsets of
    box sums of 1/16-multiples, all exact in f32;
  * oriented descriptors: the orientation is atan2 of two moments that the
    port sums exactly (f64, rounded once) and the reference sums in f32, and
    atan2/cos/sin differ in the last ulp between XLA and PyTorch, so a
    sample pair that nearly ties can compare the other way.  Measured: no
    differing bit on this scene (1751 descriptors); 3 bits in 2048
    descriptors (a share of 5.7e-6, at most 1 bit per descriptor) on two
    frames of the 1241x376 bench scene.  The test allows a share of 1e-4
    and 2 bits per descriptor;
  * orientation: atol 1e-6 rad (measured 2.4e-7: the reference's f32
    moment sums);
  * Shi-Tomasi and Harris responses: XLA's CPU backend contracts multiply-
    adds into FMAs (ROADMAP Queue 3); Harris rtol 1e-5 of the largest
    response (its det exceeds 2^24), keypoint xy atol 1e-3 px;
  * the antialiased resize: weights within 2^-19 (32 ulps of 1; the reference's
    normalising sum is in its compiler's order), pixels atol 1e-3 of 255
    (the reference applies the weights as a matmul, the port as a banded
    sum in ascending order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

import rso.frontend.detect as jd
import rso.frontend.pyramid as jp
from rso.config import DetectParams as JDP
from rso.frontend.orb_pattern import LEARNED_PATTERN as J_PATTERN
import rso_torch.frontend.detect as td
from rso_torch.config import DetectMethod, DetectParams as TDP, NMSMethod
from rso_torch.frontend.orb_pattern import LEARNED_PATTERN as T_PATTERN
from rso_torch.synthetic import make_sequence

H, W = 160, 240
# oriented descriptors: the share of differing bits over all descriptors,
# and the largest per-descriptor distance (see the module docstring)
ORIENTED_BIT_SHARE = 1e-4
ORIENTED_MAX_BITS = 2


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
    seq = make_sequence(n_frames=4, n_points=1800, H=H, W=W)
    return [(l.astype(np.float32), r.astype(np.float32)) for l, r in seq.frames]


def _t(a):
    return torch.from_numpy(np.array(a))


def _keypoints(img, k=128):
    """Reference FAST keypoints of one image, inside the descriptor margin."""
    f = jax.jit(jd.detect_features, static_argnums=(1, 2, 4))(
        jnp.asarray(img), JDP(), k, jnp.int32(20), True)
    return np.asarray(f.xy)[np.asarray(f.valid)]


def _bits(words):
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=-1)


def test_learned_pattern_is_the_reference_table():
    assert T_PATTERN.dtype == J_PATTERN.dtype
    np.testing.assert_array_equal(T_PATTERN, J_PATTERN)


def test_pack_bits_sets_the_top_bit():
    bits = np.zeros((3, 64), bool)
    bits[0, 31] = True                      # word 0 = 2^31
    bits[1, :] = True                       # both words all ones
    bits[2, [0, 33, 63]] = True
    out = td.pack_bits(torch.from_numpy(bits)).numpy()
    ref = [[sum(1 << b for b in range(32) if row[32 * w + b])
            for w in range(2)] for row in bits]
    np.testing.assert_array_equal(out.view(np.uint32),
                                  np.array(ref, np.uint32))
    assert out.dtype == np.int32 and out[0, 0] == -2**31 and out[1, 1] == -1


def test_shi_tomasi_sqrt_is_correctly_rounded(rng):
    """The Shi-Tomasi root is numpy's correctly rounded float32 sqrt, as
    kernel 1's __fsqrt_rn and CUDA compute it; PyTorch's vectorised CPU sqrt
    is not, and would part the CPU twin from the kernel by an ulp."""
    x = np.concatenate([rng.uniform(0, 1e4, 200_000),
                        [0.0, 1.0, 2.0, 1e-30, 3e38]]).astype(np.float32)
    np.testing.assert_array_equal(td._sqrt_rn(_t(x)).numpy(), np.sqrt(x))


def test_extract_patches_wide_exact(frames, rng):
    img = frames[0][0]
    xy = np.stack([rng.uniform(-5, W + 5, 40), rng.uniform(-5, H + 5, 40)],
                  -1).astype(np.float32)
    ref = jd.extract_patches_wide(jnp.asarray(img), jnp.asarray(xy), 37, 18)
    out = td.extract_patches_wide(_t(img), _t(xy), 37, 18)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_orb_orientation(frames):
    img = frames[0][0]
    xy = _keypoints(img)
    patches = np.asarray(jd.extract_patches_wide(jnp.asarray(img),
                                                 jnp.asarray(xy), 37, 18))
    ref = np.asarray(jax.jit(jax.vmap(jd.orb_orientation))(
        jnp.asarray(patches[:, 3:34, 3:34])))
    out = td.orb_orientation(_t(patches[:, 3:34, 3:34])).numpy()
    assert len(xy) > 40
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("upright", [True, False])
def test_orb_descriptors(frames, upright):
    n_bits, worst, n_desc = 0, 0, 0
    for left, right in frames:
        for img in (left, right):
            xy = _keypoints(img)
            ref = np.asarray(jax.jit(jd.orb_descriptors, static_argnums=2)(
                jnp.asarray(img), jnp.asarray(xy), upright))
            out = td.orb_descriptors(_t(img), _t(xy), upright).numpy()
            if upright:
                np.testing.assert_array_equal(out, ref.view(np.int32))
            d = _bits(out ^ ref.view(np.int32)).sum(-1)
            n_bits += int(d.sum())
            worst = max(worst, int(d.max()))
            n_desc += len(xy)
    assert n_desc > 300
    assert n_bits / (256 * n_desc) <= ORIENTED_BIT_SHARE, n_bits
    assert worst <= ORIENTED_MAX_BITS


def test_harris_response(frames):
    img = frames[0][0]
    ref = np.asarray(jax.jit(jd.harris_response)(jnp.asarray(img)))
    out = td.harris_response(_t(img)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("num_out", [200, 60])
def test_adaptive_nms_select(rng, num_out):
    K = 256
    xy = rng.integers(0, 200, (K, 2)).astype(np.float32)
    resp = (rng.integers(1, 50, K) * 2.0).astype(np.float32)   # many ties
    valid = rng.random(K) > 0.2
    ref = jd.adaptive_nms_select(jnp.asarray(xy), jnp.asarray(resp),
                                 jnp.asarray(valid), num_out)
    out = td.adaptive_nms_select(_t(xy), _t(resp), _t(valid), num_out)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert 0 < out.sum() <= num_out


@pytest.mark.parametrize("shape", [(160, 240), (376, 1241)])
def test_resize_weights_and_pixels(shape, rng):
    """Every level size _detect_orb_multilevel uses for this image size."""
    img = (rng.integers(0, 255 * 16, shape) / 16.0).astype(np.float32)
    for lv in range(1, 8):
        s = 1.2 ** lv
        hl, wl = (max(int(round(shape[0] / s)), 64),
                  max(int(round(shape[1] / s)), 64))
        for m, n in ((shape[0], hl), (shape[1], wl)):
            ref = np.asarray(jax.jit(lambda m=m, n=n: compute_weight_mat(
                m, n, n / m, 0.0, _fill_triangle_kernel, True))())
            np.testing.assert_allclose(td._resize_weights(m, n), ref,
                                       rtol=0, atol=2.0**-19)
        if shape == (160, 240) or lv in (1, 7):
            ref = np.asarray(jax.image.resize(jnp.asarray(img), (hl, wl),
                                              method="bilinear"))
            out = td.resize_bilinear(_t(img), (hl, wl)).numpy()
            np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("k,nlevels", [(512, 8), (5, 8), (100, 3)])
def test_orb_level_budgets(k, nlevels):
    assert td._orb_level_budgets(k, nlevels) == jd._orb_level_budgets(k, nlevels)


_MODES = {
    "fast_orb": (dict(detect_method=DetectMethod.FAST_ORB, orb_upright=True), True, 3),
    "klt": (dict(detect_method=DetectMethod.KLT, minimum_KLT_response=5.0), False, 3),
    "klt_adaptive": (dict(detect_method=DetectMethod.KLT, minimum_KLT_response=5.0,
                          nmsMethod=NMSMethod.ADAPTIVE), False, 3),
    "faster_adaptive": (dict(nmsMethod=NMSMethod.ADAPTIVE), False, 3),
    "faster_no_nms": (dict(non_maximal_suppression=False), False, 1),
    "orb_one_level": (dict(detect_method=DetectMethod.ORB, orb_nlevels=1,
                           orb_upright=True), True, 1),
    "orb_multilevel": (dict(detect_method=DetectMethod.ORB, orb_upright=True), True, 1),
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_detect_features_modes(frames, mode):
    """Integer fields and descriptors exact, xy within 1e-3 px, responses
    within rtol 1e-5 (FMA contraction on the reference side)."""
    kw, need_desc, octaves = _MODES[mode]
    det = jax.jit(jd.detect_features, static_argnums=(1, 2, 4))
    n_valid = 0
    for left, right in frames[:2]:
        for img in (left, right):
            pyr = jp.build_pyramid(jnp.asarray(img), octaves)
            for o, k in zip(range(octaves), (512, 256, 128)):
                fj = det(pyr[o], JDP(**kw), k, jnp.int32(20), need_desc)
                ft = td.detect_features(_t(pyr[o]), TDP(**kw), k,
                                        torch.tensor(20, dtype=torch.int32),
                                        need_desc)
                np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
                np.testing.assert_array_equal(ft.desc.numpy(),
                                              np.asarray(fj.desc).view(np.int32))
                np.testing.assert_array_equal(ft.patch.numpy(), np.asarray(fj.patch))
                np.testing.assert_allclose(ft.xy.numpy(), np.asarray(fj.xy), atol=1e-3)
                r = np.asarray(fj.response)
                np.testing.assert_allclose(ft.response.numpy(), r, rtol=1e-5,
                                           atol=1e-5 * np.abs(r).max())
                n_valid += int(ft.valid.sum())
    assert n_valid > 200
