"""rso_torch.random: threefry-2x32 keys and uniform draws, bit-exact with
jax.random (jax's default threefry with jax_threefry_partitionable=True)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rso_torch import random as R


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(key_or_bits):
    return np.asarray(key_or_bits).astype(np.int64)


def test_partitionable_threefry_is_the_reference():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**32 - 1])
def test_prng_key(seed):
    assert np.array_equal(_np(jax.random.PRNGKey(np.uint32(seed))),
                          R.PRNGKey(seed).numpy())


@pytest.mark.parametrize("data", [0, 1, 2, 29, 1000, 2**31 - 1])
def test_fold_in(data):
    kj = jax.random.fold_in(jax.random.PRNGKey(7), jnp.int32(data))
    kt = R.fold_in(R.PRNGKey(7), torch.tensor(data, dtype=torch.int32))
    assert np.array_equal(_np(kj), kt.numpy())


@pytest.mark.parametrize("num", [2, 3])
def test_split(num):
    kj = jax.random.split(jax.random.PRNGKey(42), num)
    assert np.array_equal(_np(kj), R.split(R.PRNGKey(42), num).numpy())


@pytest.mark.parametrize("shape", [(256, 8), (3, 5), (1,)])
def test_uniform(shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    uj = np.asarray(jax.random.uniform(kj, shape))
    ut = R.uniform(R.fold_in(R.PRNGKey(7), 3), shape).numpy()
    assert ut.dtype == np.float32 and ut.shape == shape
    assert np.array_equal(uj, ut)


@pytest.mark.parametrize("frame", [0, 1, 17])
def test_engine_key_schedule(frame):
    """The engine's RANSAC draws: fold_in(PRNGKey(7), frame), fold_in(1000),
    split into one key per eye, uniform (256, 8) each (rso/engine.py)."""
    key = jax.random.fold_in(jax.random.PRNGKey(7), jnp.int32(frame))
    kL, kR = jax.random.split(jax.random.fold_in(key, 1000))
    ref = np.stack([jax.random.uniform(kL, (256, 8)),
                    jax.random.uniform(kR, (256, 8))])
    keys = R.split(R.fold_in(R.fold_in(R.PRNGKey(7), torch.tensor(frame)), 1000))
    assert np.array_equal(R.uniform(keys, (256, 8)).numpy(), ref)
