"""Fixed-batch 8-point RANSAC for the fundamental matrix.

Counterpart of rso/solver/ransac.py `ransac_fundamental`: stratified
distinct sampling from uniform draws identical to jax.random's
(rso_torch.random), the normalised 8-point solve through the batched 9x9
null vector (kernel 4, kernels/smallchol.py), Sampson scoring, the
least-squares refit of the best model on its inliers, and the >= 8 / >= 25%
acceptance with pass-through.

Both eyes run in one call: points carry a leading eye axis [E,N,2] with one
key per eye [E,2] and one shared mask [N], so the hypothesis solve is one
[E*H,9,9] batch, as the reference's vmap over eyes makes it.

On CUDA tensors `ransac_fundamental` is one launch of the RANSAC kernel
(rso_torch/kernels/ransac.py, csrc/ransac.cu): the draws, indices and
normalisation bit for bit as `ransac_fundamental_torch` makes them on the
card, the hypotheses' sums in its own fixed order.  The CPU keeps
`ransac_fundamental_torch`, the plain path described here.  A key is an
explicit key or a rso_torch.random.FrameKeys (the engine's).

The filter's own arithmetic (normalisation, normal equations,
de-normalisation, Sampson scoring) runs in `PREC`; kernel 4 takes and
returns float32.  `PREC` is float32, as in the reference, whose results the
port reproduces on the CPU.  In float32 the sums run in another order on
cuBLAS than on the CPU, which moves a hypothesis's inlier count by a track
now and then; where hypotheses tie at the top, the devices pick other
winners.  tests/_torch_ransac_devices.py measures this on the card, with
`PREC` float32 and float64.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from rso_torch import random as rrandom
from rso_torch.kernels.ransac import ransac_cuda
from rso_torch.kernels.smallchol import nullvec9_auto

PREC = torch.float32


class RansacResult(NamedTuple):
    inliers: torch.Tensor    # [..., N] bool
    F: torch.Tensor          # [..., 3, 3] best fundamental matrix
    n_inliers: torch.Tensor  # [...] int32
    ok: torch.Tensor         # [...] bool: >= 8 inliers and >= 25% of the set


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a tree of elementwise adds (zero-padded to a
    power of two, halved until one value is left): the order of the adds
    is fixed by the axis's length alone, so the sum has the same bits
    whatever the leading axes, under vmap too."""
    n = x.shape[-1]
    x = F.pad(x, (0, (1 << max(n - 1, 0).bit_length()) - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _sum_points(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over the points axis `dim` with the same bits whatever the
    leading axes, so that a lane of the batched step (torch.func.vmap) sums
    as a lone step does.  On the CPU that is torch's sum (the reference's
    bits on the repo's scenes); on the GPU CUDA's reduction kernel picks
    its order from the number of outputs, so there a `_pairwise_sum`."""
    if x.device.type == "cpu":
        return x.sum(dim)
    return _pairwise_sum(x.movedim(dim, -1))


def _normalize_pts(pts: torch.Tensor, mask: torch.Tensor):
    """Hartley normalisation of [...,N,2] (masked): zero mean, mean distance
    sqrt(2).  Returns (normalised points, T [...,3,3])."""
    w = mask.to(pts.dtype)
    n = torch.clamp(w.sum(-1), min=1.0)          # a count: exact in any order
    mean = _sum_points(pts * w[..., None], -2) / n[..., None]
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1))
    scale = math.sqrt(2.0) / torch.clamp(_sum_points(d * w, -1) / n, min=1e-9)
    zero = torch.zeros_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0]], dim=-1),
        torch.stack([zero, scale, -scale * mean[..., 1]], dim=-1),
        torch.stack([zero, zero, torch.ones_like(scale)], dim=-1),
    ], dim=-2)
    return (pts - mean[..., None, :]) * scale[..., None, None], T


def _design_rows(p1n: torch.Tensor, p2n: torch.Tensor) -> torch.Tensor:
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def _solve_eight_point(p1n: torch.Tensor, p2n: torch.Tensor) -> torch.Tensor:
    """F (normalised coords) from [..., 8, 2] samples: the null vector of
    M = A^T A through one flat [B,9,9] batch."""
    A = _design_rows(p1n, p2n)                                 # [...,8,9]
    return _null_vector(A.transpose(-1, -2) @ A)


def _null_vector(M: torch.Tensor) -> torch.Tensor:
    """The null vector of [...,9,9] M as [...,3,3]: kernel 4 on M rounded to
    float32, returned in M's dtype."""
    x = nullvec9_auto(M.reshape(-1, 9, 9).to(torch.float32).contiguous())
    return x.to(M.dtype).reshape(*M.shape[:-2], 3, 3)


def _sampson_sq(F: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Squared Sampson distance (pixel^2) of [...,N,2] pairs to F [...,3,3]."""
    x1 = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    x2 = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1)
    Fx1 = x1 @ F.transpose(-1, -2)
    Ftx2 = x2 @ F
    num = (x2 * Fx1).sum(-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


def sample_indices(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw per rank stratum: 8 distinct valid indices per hypothesis
    from the uniform draws u [..., H, 8] over mask [N]."""
    N = mask.shape[-1]
    c = torch.cumsum(mask.to(torch.int32), dim=0)
    n_valid = torch.clamp(c[-1], min=1)
    lanes = torch.arange(8, dtype=torch.int32, device=mask.device)
    lo = (lanes * n_valid) // 8
    hi = ((lanes + 1) * n_valid) // 8
    width = torch.clamp(hi - lo, min=1).to(torch.float32)
    ranks = lo + torch.floor(u * width).to(torch.int32)
    ranks = torch.minimum(ranks, n_valid - 1)
    idx = torch.searchsorted(c, ranks, right=True)
    return torch.clamp(idx, max=N - 1)


def ransac_fundamental(p1: torch.Tensor, p2: torch.Tensor, mask: torch.Tensor,
                       key, n_iters: int = 64, threshold: float = 1.0,
                       draws: torch.Tensor | None = None) -> RansacResult:
    """Fixed-batch 8-point RANSAC, all hypotheses in parallel: one launch of
    the RANSAC kernel on CUDA tensors, `ransac_fundamental_torch` on the
    CPU.

    p1, p2: [N,2] or [E,N,2]; mask: [N]; key: [2] or [E,2], or a
    rso_torch.random.FrameKeys.  `draws` ([..., n_iters, 8] in [0,1))
    replaces the uniform draws from `key`.
    """
    if p1.device.type == "cpu":
        return ransac_fundamental_torch(p1, p2, mask, key, n_iters, threshold,
                                        draws)
    single = p1.ndim == 2
    if single:
        p1, p2 = p1[None], p2[None]
        draws = None if draws is None else draws[None]
    res = RansacResult(*ransac_cuda(p1, p2, mask, key, n_iters=n_iters,
                                    threshold=threshold, draws=draws))
    return RansacResult(*(t[0] for t in res)) if single else res


def ransac_fundamental_torch(p1: torch.Tensor, p2: torch.Tensor,
                             mask: torch.Tensor, key, n_iters: int = 64,
                             threshold: float = 1.0,
                             draws: torch.Tensor | None = None) -> RansacResult:
    """The plain path of `ransac_fundamental`, on any device."""
    single = p1.ndim == 2
    if isinstance(key, rrandom.FrameKeys):
        key = key.keys(1 if single else p1.shape[0])
        key = key[0] if single else key
    if single:
        p1, p2, key = p1[None], p2[None], key[None]
        draws = None if draws is None else draws[None]
    p1 = p1.to(torch.float32).to(PREC)
    p2 = p2.to(torch.float32).to(PREC)
    thr2 = threshold * threshold
    p1n, T1 = _normalize_pts(p1, mask)
    p2n, T2 = _normalize_pts(p2, mask)

    u = rrandom.uniform(key, (n_iters, 8)) if draws is None else draws
    idx = sample_indices(mask, u)                              # [E,H,8]
    c = torch.cumsum(mask.to(torch.int32), dim=0)

    E = p1.shape[0]
    eye = torch.arange(E, device=p1.device)[:, None, None]
    F = _solve_eight_point(p1n[eye, idx], p2n[eye, idx])        # [E,H,3,3]
    Fs = T2.transpose(-1, -2)[:, None] @ F @ T1[:, None]        # de-normalise
    d2h = _sampson_sq(Fs, p1[:, None], p2[:, None])             # [E,H,N]
    inlh = mask & (d2h <= thr2)
    scores = inlh.sum(-1, dtype=torch.int32)                    # [E,H]
    best = torch.argmax(scores, dim=-1)                         # first max
    e = torch.arange(E, device=p1.device)

    # least-squares refit of the best model on all its inliers
    Arows = _design_rows(p1n, p2n) * inlh[e, best].to(PREC)[..., None]
    Fr = _null_vector(Arows.transpose(-1, -2) @ Arows)          # [E,3,3]
    Fr = T2.transpose(-1, -2) @ Fr @ T1
    d2r = _sampson_sq(Fr, p1, p2)                               # [E,N]
    score_r = (mask & (d2r <= thr2)).sum(-1, dtype=torch.int32)
    use_r = score_r >= scores[e, best]
    Fbest = torch.where(use_r[:, None, None], Fr, Fs[e, best])
    d2 = torch.where(use_r[:, None], d2r, d2h[e, best])

    inliers = mask & (d2 <= thr2)
    n_inl = inliers.sum(-1, dtype=torch.int32)
    ok = (n_inl >= 8) & (n_inl.to(torch.float32)
                         >= 0.25 * c[-1].to(torch.float32))
    inliers = torch.where(ok[:, None], inliers, mask.expand_as(inliers))
    res = RansacResult(inliers=inliers, F=Fbest.to(torch.float32),
                       n_inliers=n_inl, ok=ok)
    if single:
        res = RansacResult(*(t[0] for t in res))
    return res
