"""Threefry-2x32 keys and uniform draws, bit-exact with `jax.random`.

The reference draws its RANSAC hypotheses with `jax.random` (keys folded
from PRNGKey(7) by frame index, rso/engine.py), so the port reproduces the
generator itself: `PRNGKey`, `fold_in`, `split` and `uniform` of jax's
default threefry implementation with `jax_threefry_partitionable=True`.
Everything runs on the key's device with no host round trip.  torch's
uint32 support is incomplete, so the 32-bit words live in int64 tensors
masked to 32 bits.  A key is an int64 tensor [..., 2].
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x1, x2) under
    key (k1, k2); all int64 tensors holding uint32 values, broadcastable."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x[0], x[1]


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.PRNGKey(seed) for a seed in [0, 2**32)."""
    key = torch.zeros(2, dtype=torch.int64, device=device)
    key[1] = seed & _M32            # a fill, no host-to-device copy
    return key


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: hash the counter pair (0, data) under key."""
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & _M32
    else:
        d = torch.full((), int(data) & _M32, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def _iota_bits(key: torch.Tensor, n: int):
    """Hash of the counters 0..n-1 (high word 0) under each key [..., 2]."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0, None], key[..., 1, None],
                        torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split -> [..., num, 2]."""
    b1, b2 = _iota_bits(key, num)
    return torch.stack([b1, b2], dim=-1)


def uniform(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """jax.random.uniform(key, shape) in [0, 1), float32 -> [..., *shape]."""
    n = 1
    for s in shape:
        n *= s
    b1, b2 = _iota_bits(key, n)
    bits = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
    floats = bits.view(torch.float32) - 1.0
    return floats.reshape(*key.shape[:-1], *shape)
