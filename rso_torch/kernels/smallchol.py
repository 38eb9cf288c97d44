"""Kernel 4: batched 9x9 PSD null vectors for the RANSAC 8-point solve.

Replaces rso/kernels/smallchol.py `nullvec9_pallas` (see the header of
csrc/smallchol.cu for the H100 bound and the design).  As in the reference,
the two sides run two algorithms: the CUDA kernel is the TPU kernel's LDL^T,
the twin `nullvec9_torch` is `nullvec9_jnp`'s regularised Cholesky.  They
agree up to sign.
"""
from __future__ import annotations

import torch

from rso_torch.kernels import _lib

_N = 9


def nullvec9_torch(M: torch.Tensor) -> torch.Tensor:
    """[B,9,9] PSD rank-<=8 -> [B,9] unit approximate null vectors:
    regularised Cholesky + two rounds of inverse iteration."""
    eps = (3e-7 * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
           + 1e-12)[..., None, None]
    L, info = torch.linalg.cholesky_ex(
        M + eps * torch.eye(_N, dtype=M.dtype, device=M.device))
    # a failed factorisation is NaN, as jnp.linalg.cholesky reports it
    L = torch.where((info == 0)[..., None, None], L,
                    torch.full_like(L, torch.nan))
    x = torch.full(M.shape[:-1], 1.0 / 3.0, dtype=M.dtype, device=M.device)
    for _ in range(2):
        y = _cho_solve_unrolled(L, x)
        x = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True),
                            min=1e-30)
    return x


def _cho_solve_unrolled(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L L^T)^{-1} b by unrolled substitution, renormalised between the
    two half-solves (direction only; bounds f32 magnitudes)."""
    n = L.shape[-1]
    ys = []
    for i in range(n):                       # L y = b
        acc = b[..., i]
        for j in range(i):
            acc = acc - L[..., i, j] * ys[j]
        ys.append(acc / L[..., i, i])
    y = torch.stack(ys, dim=-1)
    y = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True), min=1e-30)
    xs = [None] * n
    for i in reversed(range(n)):             # L^T x = y
        acc = y[..., i]
        for j in range(i + 1, n):
            acc = acc - L[..., j, i] * xs[j]
        xs[i] = acc / L[..., i, i]
    return torch.stack(xs, dim=-1)


def nullvec9_cuda(M: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: one hypothesis per thread, LDL^T in registers."""
    _lib.load()
    if not M.is_cuda:
        raise ValueError(f"nullvec9_cuda: M on {M.device}")
    B = M.shape[0]
    if B == 0:
        raise ValueError("nullvec9_cuda: empty batch")
    m = _lib.check(M, "M", torch.float32, (B, _N, _N), M.device)
    out = torch.empty(B, _N, dtype=torch.float32, device=M.device)
    _lib.launch("nullvec9", m, out.data_ptr(), B)
    return out


def nullvec9_auto(M: torch.Tensor) -> torch.Tensor:
    """The twin for a CPU tensor, the CUDA kernel for anything else."""
    if M.device.type == "cpu":
        return nullvec9_torch(M)
    return nullvec9_cuda(M)
