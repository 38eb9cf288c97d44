"""The RANSAC kernel (rso_torch/csrc/ransac.cu) against the plain path
(rso_torch.solver.ransac.ransac_fundamental_torch) on the card.

Every test is marked `gpu` and skips without a CUDA device.  The file
imports neither jax nor rso:

    python -m pytest --noconftest -m gpu tests/test_torch_ransac_cuda.py

Inputs and tolerances: tests/_torch_ransac_cases.py (the draws, the sample
indices, T1, T2 and the null vectors bit for bit; the count, F and the
mask within its stated bounds).  A lane in a batch is its lone launch bit
for bit (a lane is blocks running the same code).
"""
import pytest
import torch

import _torch_card as card
import _torch_ransac_cases as C
from rso_torch import random as rrandom
from rso_torch.graphs import reset_launches, settle_launches
from rso_torch.kernels import _lib
from rso_torch.kernels.ransac import ransac_probe
from rso_torch.solver import ransac as R


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return torch.device("cuda")


def _run(p1, p2, mask, key, H, draws=None):
    """The kernel (one launch, counted) and its intermediates."""
    reset_launches()
    got = R.ransac_fundamental(p1, p2, mask, key, n_iters=H,
                               threshold=C.THRESHOLD, draws=draws)
    torch.cuda.synchronize()
    assert dict(settle_launches()) == {"ransac": 1}
    _, probe = ransac_probe(p1, p2, mask, key, n_iters=H,
                            threshold=C.THRESHOLD, draws=draws)
    card.same_bits("the probe's launch against the kernel's", _, got)
    return got, probe


@pytest.mark.gpu
@pytest.mark.parametrize("E,N,H,kind", C.SHAPES)
def test_cuda_ransac_matches_the_plain_path(cuda, E, N, H, kind):
    """The engine's keys (the frame index and the call's counter), against
    the plain path on the same card."""
    seed = N + H + E
    p1, p2, mask = C.case(seed, E, N, kind, cuda)
    key = C.frame_keys(seed, cuda)
    got, _ = _run(p1, p2, mask, key, H)
    want = R.ransac_fundamental_torch(p1, p2, mask, key, n_iters=H,
                                      threshold=C.THRESHOLD)
    print(E, N, H, kind, card.check_kernel("ransac", got, want, p1=p1, p2=p2,
                                           mask=mask, key=key, H=H))


@pytest.mark.gpu
@pytest.mark.parametrize("octave", [0, 1, 2])
def test_cuda_ransac_flow_keys(cuda, octave):
    """The flow path's per-octave keys, split(fold_in(frame key, octave)),
    at its slots (512 / 256 / 128)."""
    N = 512 >> octave
    p1, p2, mask = C.case(40 + octave, 2, N, "some", cuda)
    key = rrandom.FrameKeys(torch.tensor(9, dtype=torch.int32, device=cuda),
                            octave)
    got, probe = _run(p1, p2, mask, key, 256)
    want = R.ransac_fundamental_torch(p1, p2, mask, key, n_iters=256)
    C.compare(got, probe, want, p1, p2, mask, key.keys(2), 256)


@pytest.mark.gpu
def test_cuda_ransac_explicit_keys_and_draws(cuda):
    """An explicit key an eye, a single view's [N,2] with one key, and
    injected draws, which replace the key."""
    p1, p2, mask = C.case(5, 2, 512, "some", cuda)
    keys = rrandom.split(rrandom.PRNGKey(11, cuda))
    got, probe = _run(p1, p2, mask, keys, 128)
    want = R.ransac_fundamental_torch(p1, p2, mask, keys, n_iters=128)
    C.compare(got, probe, want, p1, p2, mask, keys, 128)
    for e in range(2):
        one = R.ransac_fundamental(p1[e], p2[e], mask, keys[e], n_iters=128)
        assert torch.equal(one.inliers, got.inliers[e])
        assert torch.equal(one.F, got.F[e])
    draws = rrandom.uniform(keys, (128, 8))
    other = rrandom.split(rrandom.PRNGKey(99, cuda))
    injected, probe = _run(p1, p2, mask, other, 128, draws=draws)
    assert torch.equal(probe["draws"], draws)
    card.same_bits("injected draws", injected, got)


@pytest.mark.gpu
def test_cuda_ransac_lanes_are_lone_calls(cuda):
    """Under vmap, 11 lanes (each its own points, mask and frame index) are
    one launch, each lane its lone call bit for bit; one mask for every
    lane takes a lanes' stride of 0."""
    B, N = 11, 896
    cases = [C.case(100 + b, 2, N, "some", cuda) for b in range(B)]
    p1, p2, mask = (torch.stack([c[i] for c in cases]) for i in range(3))
    frame = torch.arange(B, dtype=torch.int32, device=cuda) + 30

    def call(a, b, m, f):
        return tuple(R.ransac_fundamental(a, b, m, rrandom.FrameKeys(f, 1000),
                                          n_iters=256))

    for shared in (False, True):
        m = mask[0] if shared else mask
        reset_launches()
        out = torch.func.vmap(call, in_dims=(0, 0, None if shared else 0, 0))(
            p1, p2, m, frame)
        torch.cuda.synchronize()
        assert dict(settle_launches()) == {"ransac": 1}
        card.check_lanes("ransac", out, lambda b: call(
            p1[b], p2[b], m if shared else mask[b], frame[b]), B)


@pytest.mark.gpu
def test_cuda_ransac_in_a_graph(cuda):
    """Captured in a CUDA graph (no host read, no allocation outside the
    graph's pool), a replay on new inputs gives the eager call's bits."""
    p1, p2, mask = C.case(3, 2, 896, "some", cuda)
    frame = torch.tensor(4, dtype=torch.int32, device=cuda)
    key = rrandom.FrameKeys(frame, 1000)
    R.ransac_fundamental(p1, p2, mask, key, n_iters=256)   # built, warm
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = R.ransac_fundamental(p1, p2, mask, key, n_iters=256)
    q1, q2, qm = C.case(4, 2, 896, "some", cuda)
    p1.copy_(q1)
    p2.copy_(q2)
    mask.copy_(qm)
    frame.fill_(5)
    g.replay()
    torch.cuda.synchronize()
    want = R.ransac_fundamental(q1, q2, qm, rrandom.FrameKeys(
        torch.tensor(5, dtype=torch.int32, device=cuda), 1000), n_iters=256)
    card.same_bits("a replay", out, want)


@pytest.mark.gpu
def test_cuda_ransac_points_in_global_scratch(cuda, monkeypatch):
    """Where the points would not fit a block's shared memory the kernel
    keeps them in global scratch: the same bits."""
    from rso_torch.kernels import ransac as KR

    p1, p2, mask = C.case(8, 2, 1024, "some", cuda)
    key = C.frame_keys(8, cuda)
    shared = R.ransac_fundamental(p1, p2, mask, key, n_iters=256)
    monkeypatch.setattr(KR, "_fits", lambda device, N, H: False)
    scratch = R.ransac_fundamental(p1, p2, mask, key, n_iters=256)
    card.same_bits("global scratch", scratch, shared)
    assert _lib.load().rso_ransac_fits(1024, 256) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("flow", [False, True])
def test_cuda_engine_hashes_no_key(cuda, monkeypatch, flow):
    """The engine on the card runs no threefry of rso_torch.random (the
    kernel hashes the frame index itself): one RANSAC launch a frame on
    the SAD path, one an octave on the flow path, and no kernel 4; the
    frames run eager, then captured, then replayed."""
    import dataclasses

    import numpy as np

    from rso_torch.engine import Engine
    from rso_torch.synthetic import make_sequence, synthetic_config

    def hashed(*a, **kw):
        raise AssertionError("a key hashed by rso_torch.random on the card")

    monkeypatch.setattr(rrandom, "threefry2x32", hashed)
    cfg = synthetic_config()
    if flow:
        cfg = cfg.replace(if_match=dataclasses.replace(cfg.if_match,
                                                        ifm_method=3))
    seq = make_sequence(n_frames=5, n_points=2000, H=376, W=1241, seed=0)
    eng = Engine(cfg, seq.cam, device=cuda)
    for i in range(len(seq.frames)):
        reset_launches()
        res = eng.process_frame(*seq.frames[i])
        launches = dict(settle_launches())
        assert launches.get("ransac") == (cfg.n_octaves if flow else 1), launches
        assert not launches.get("nullvec9"), launches
        assert np.isfinite(res.pose.cpu().numpy()).all()
