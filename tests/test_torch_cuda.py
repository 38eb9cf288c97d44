"""The CUDA kernels against their PyTorch twins, on the card.

Every test here is marked `gpu` and skips without a CUDA device.  The file
imports neither jax nor rso, so it also runs on a GPU host without jax:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: FAST masks, SAD indices and distances bit-exact; the corner
response bit-exact too (same operation order, round-to-nearest intrinsics,
the same float32 reciprocal for the window mean), checked at 1e-6; null
vectors up to sign (|cos| > 1 - 1e-3, unit norm to 1e-4): the kernel is
LDL^T, the twin regularised Cholesky.
"""
import numpy as np
import pytest
import torch

from rso_torch import kernels as K
from rso_torch.frontend.pyramid import build_pyramid, to_grayscale
from rso_torch.synthetic import make_sequence


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return torch.device("cuda")


def _stereo_case(k, seed, dev):
    r = np.random.default_rng(seed)
    perm = r.permutation(k)
    pl = r.integers(0, 255 * 16, (k, 64)) / 16.0
    pr = np.clip(pl[perm] + r.integers(-40, 40, (k, 64)) / 16.0, 0, 255)
    xy_l = r.uniform(10, 300, (k, 2))
    xy_r = xy_l[perm] - np.stack([r.uniform(-2, 40, k), r.uniform(-1, 1, k)], -1)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    ok = lambda: torch.tensor(r.random(k) > 0.1, device=dev)  # noqa: E731
    return f(pl), f(pr), f(xy_l), f(xy_r), ok(), ok()


@pytest.mark.gpu
@pytest.mark.parametrize("th", [10, 20, 25])
def test_cuda_corner_response(cuda, th):
    seq = make_sequence(n_frames=1, n_points=2000, H=376, W=1241)
    img = to_grayscale(torch.from_numpy(seq.frames[0][0]).to(cuda))
    for octave in build_pyramid(img, 3):
        out = K.corner_response_cuda(octave, th)
        ref = K.corner_response_torch(octave, th)
        assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
        fin = torch.isfinite(ref)
        torch.testing.assert_close(out[fin], ref[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [512, 257, 128, 1])
def test_cuda_stereo_sad_fused(cuda, k):
    args = _stereo_case(k, k, cuda)
    kw = dict(max_y_diff=1.0, max_disp=100.0, max_distance=1200.0)
    for o, r in zip(K.stereo_sad_fused_cuda(*args, **kw),
                    K.stereo_sad_fused_torch(*args, **kw)):
        assert torch.equal(o, r)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [512, 131, 128])
def test_cuda_track_sad_fused(cuda, k):
    p1, c1, xy1, xy2, okp, okc = _stereo_case(k, k, cuda)
    p2, c2, _, _, _, _ = _stereo_case(k, k + 1, cuda)
    args = (p1, c1, p2, c2, xy1, xy2, xy1[:, 0] - 5.0, xy2[:, 0] - 7.0, okp, okc)
    kw = dict(win_row=8.0, win_col=40.0, sad_max=1200.0)
    for o, r in zip(K.track_sad_fused_cuda(*args, **kw),
                    K.track_sad_fused_torch(*args, **kw)):
        assert torch.equal(o, r)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [512, 2, 1])
def test_cuda_nullvec9(cuda, B):
    A = torch.tensor(np.random.default_rng(B).normal(0, 1, (B, 8, 9)),
                     dtype=torch.float32, device=cuda)
    M = (A.transpose(1, 2) @ A).contiguous()
    out = K.nullvec9_cuda(M)
    ref = K.nullvec9_torch(M)
    assert (out * ref).sum(1).abs().min().item() > 1.0 - 1e-3
    torch.testing.assert_close(out.norm(dim=1), torch.ones(B, device=cuda),
                               rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_cuda_wrappers_count_launches_and_check_operands(cuda):
    K.LAUNCHES.clear()
    img = torch.zeros((32, 48), device=cuda)
    K.corner_response_cuda(img, 20)
    assert K.LAUNCHES["corner_response"] == 1
    with pytest.raises(ValueError, match="dtype"):
        K.corner_response_cuda(img.double(), 20)
    with pytest.raises(ValueError, match="contiguous"):
        K.nullvec9_cuda(torch.zeros((9, 9, 4), device=cuda).permute(2, 0, 1))
    assert K.LAUNCHES["corner_response"] == 1 and K.LAUNCHES["nullvec9"] == 0
