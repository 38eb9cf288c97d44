"""The keys of the engine's RANSAC calls on the CPU: rso_torch.random's
FrameKeys, which the engine passes in place of key tensors (the RANSAC
kernel hashes them itself on the card), gives the bits of the key chain it
replaces, split(fold_in(fold_in(PRNGKey(7), frame), c)) with c = 1000 (the
flat filter) or the octave (the flow path), and jax's; the filter and the
flow tracker give the same results from either; the kernel wrapper hands
the kernel the frame index and the counter, an explicit key or the draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rso_torch import random as R
from rso_torch.kernels import ransac as KR
from rso_torch.solver import ransac as S


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(frame, c):
    """Today's key tensors of call c on frame `frame`."""
    return R.split(R.fold_in(R.fold_in(R.PRNGKey(7), torch.tensor(frame)), c))


@pytest.mark.parametrize("frame", [0, 1, 17, 4539, 2**31 - 1])
@pytest.mark.parametrize("c", [1000, 0, 1, 2])
def test_frame_keys_are_the_engine_chain(frame, c):
    """FrameKeys(frame, c) is split(fold_in(fold_in(PRNGKey(7), frame), c))
    bit for bit, and jax's chain (rso/engine.py), for an int32 frame index
    as the engine's state holds it."""
    keys = R.FrameKeys(torch.tensor(frame, dtype=torch.int32), c).keys()
    assert keys.dtype == torch.int64 and keys.shape == (2, 2)
    assert torch.equal(keys, _chain(frame, c))
    kj = jax.random.fold_in(jax.random.PRNGKey(7), jnp.int32(frame))
    ref = jax.random.split(jax.random.fold_in(kj, c))
    assert np.array_equal(np.asarray(ref).astype(np.int64), keys.numpy())


def test_frame_keys_under_vmap():
    """Under vmap (the batched step) each lane's keys are its frame's."""
    frames = torch.tensor([0, 5, 9], dtype=torch.int32)
    out = torch.func.vmap(lambda f: R.FrameKeys(f, 1000).keys())(frames)
    for b, f in enumerate(frames.tolist()):
        assert torch.equal(out[b], _chain(f, 1000))


def _case(seed, n=160, n_valid=120):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(0, 1200, (2, n, 2)).astype(np.float32)
    p2 = p1 + rng.normal(0, 0.3, (2, n, 2)).astype(np.float32)
    p2[:, : n // 6] += 25.0
    mask = np.zeros(n, bool)
    mask[rng.choice(n, n_valid, replace=False)] = True
    return torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(mask)


@pytest.mark.parametrize("frame,c", [(3, 1000), (8, 0), (8, 2)])
def test_ransac_frame_keys_equal_the_key_tensors(frame, c):
    """On the CPU the filter with FrameKeys gives the bits it gives with
    the key chain's tensors, both eyes and a single view (eye 0's key)."""
    p1, p2, mask = _case(frame + c)
    fk = R.FrameKeys(torch.tensor(frame, dtype=torch.int32), c)
    keys = _chain(frame, c)
    a = S.ransac_fundamental(p1, p2, mask, fk, n_iters=64)
    b = S.ransac_fundamental(p1, p2, mask, keys, n_iters=64)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    one = S.ransac_fundamental(p1[0], p2[0], mask, fk, n_iters=64)
    for x, y in zip(one, S.ransac_fundamental(p1[0], p2[0], mask, keys[0],
                                               n_iters=64)):
        assert torch.equal(x, y)


def test_track_finish_takes_frame_keys():
    """The tracker's filter: a FrameKeys of octave o is the key tensor
    fold_in(fold_in(PRNGKey(7), frame), o) the flow path passed before."""
    from rso_torch.config import InterFrameMatchParams
    from rso_torch.frontend.detect import Features
    from rso_torch.frontend.track import _finish

    p1, p2, mask = _case(11)
    n = mask.shape[0]

    def feats(xy):
        return Features(xy=xy, response=torch.zeros(n), patch=None, desc=None,
                        valid=torch.ones(n, dtype=torch.bool))

    params = InterFrameMatchParams(filter_fund_matrix=True)
    best_c = torch.arange(n, dtype=torch.int32)
    frame = torch.tensor(6, dtype=torch.int32)
    for o in range(3):
        a = _finish(feats(p1[0]), p1[1], feats(p2[0]), p2[1], best_c, mask,
                    params, R.FrameKeys(frame, o), 64, 1.0)
        key = R.fold_in(R.fold_in(R.PRNGKey(7), frame), o)
        b = _finish(feats(p1[0]), p1[1], feats(p2[0]), p2[1], best_c, mask,
                    params, key, 64, 1.0)
        for x, y in zip(a, b):
            assert torch.equal(x, y), o


def test_kernel_operands():
    """What the wrapper hands the kernel: the frame index and the counter
    for FrameKeys; an int64 key an eye otherwise; no key where draws
    replace it."""
    p1, p2, mask = _case(2)
    frame = torch.tensor(4, dtype=torch.int32)
    (a1, a2, m, key, f, draws), data = KR._operands(
        p1, p2, mask, R.FrameKeys(frame, 1000), None)
    assert key is None and f is frame and data == 1000
    assert draws is None and m.dtype == torch.bool
    keys = R.split(R.PRNGKey(3)).to(torch.int32)
    (_, _, _, key, f, _), data = KR._operands(p1, p2, mask, keys, None)
    assert f is None and key.dtype == torch.int64 and key.shape == (2, 2)
    assert torch.equal(key, keys.to(torch.int64))
    one = KR._operands(p1[:1], p2[:1], mask, R.PRNGKey(3), None)[0][3]
    assert one.shape == (1, 2)
    u = R.uniform(keys, (64, 8))
    (_, _, _, key, f, d), _ = KR._operands(p1, p2, mask, keys, u)
    assert key is None and f is None and d is u


def test_sample_indices_are_the_strata():
    """The stratified draws: 8 distinct valid indices a hypothesis, one a
    rank stratum, in rank order; with no valid point the last index."""
    mask = torch.zeros(50, dtype=torch.bool)
    mask[torch.tensor([2, 3, 7, 11, 19, 20, 21, 30, 33, 40, 44, 49])] = True
    u = R.uniform(R.PRNGKey(5), (32, 8))
    idx = S.sample_indices(mask, u)
    valid = torch.nonzero(mask)[:, 0]
    assert mask[idx].all()
    assert (idx[:, 1:] > idx[:, :-1]).all()
    ranks = torch.searchsorted(valid, idx)
    lo = torch.arange(8) * 12 // 8
    hi = (torch.arange(8) + 1) * 12 // 8
    assert ((ranks >= lo) & (ranks < hi)).all()
    none = S.sample_indices(torch.zeros(50, dtype=torch.bool), u)
    assert (none == 49).all()
