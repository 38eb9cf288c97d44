"""Inputs and comparisons for the RANSAC kernel's checks on the card
(tests/test_torch_ransac_cuda.py, chip_smoke.py), made with the port alone,
no jax.

Inputs (`case`): two views of a seeded static cloud under a known motion,
KITTI's focal length and principal point, 0.2 px of noise and a fifth of
the pairs moved 15-40 px (gross outliers), each eye its own cloud; one mask
for both eyes with `n_valid` valid slots spread over the N.  The mask kinds
of the shapes: "some" (60% valid), "all", "few" (5 valid: fewer than the 8
a model needs) and "none".

What the kernel must give, against the plain path
(`ransac.ransac_fundamental_torch`) on the same card (`compare`):

  * bit for bit: the uniform draws, the sample indices, T1 and T2 (the
    normalisation's tree order), and each hypothesis's null vector against
    kernel 4 (`nullvec9_cuda`) on the kernel's own normal matrix;
  * ok equal; the inlier count within COUNT_SLACK; F up to sign and scale
    within F_RTOL of its largest entry (where ok; a model fitted to fewer
    than 8 points is not determined);
  * an inlier mask that differs from the plain path's only at points whose
    squared Sampson distance, under either path's model, lies within
    EDGE_PX2 of the gate (threshold^2): the hypotheses' normal matrices sum
    in another order than cuBLAS's A^T A, and the kernel tests num^2 <=
    thr2 den where the plain path divides.

Where the plain path's hypotheses tie at the top, the two may take other
winners; their refits then fit other inlier sets (`compare` reports the
winners and the gap).
"""
from __future__ import annotations

import numpy as np
import torch

from rso_torch import random as rrandom
from rso_torch.kernels.smallchol import nullvec9_cuda
from rso_torch.solver import ransac as R

# (E, N, H, mask kind) the card's checks cover
SHAPES = ([(2, n, 256, "some") for n in (128, 256, 512, 896, 1024)]
          + [(1, 896, 256, "some"), (2, 896, 64, "some"), (1, 256, 64, "some"),
             (2, 512, 256, "all"), (1, 1024, 64, "all"),
             (2, 256, 64, "few"), (1, 128, 256, "few"),
             (2, 256, 256, "none"), (1, 128, 64, "none")])
COUNT_SLACK = 3
F_RTOL = 2e-2
EDGE_PX2 = 0.05
THRESHOLD = 1.0


def n_valid(kind: str, N: int) -> int:
    return {"some": (6 * N) // 10, "all": N, "few": 5, "none": 0}[kind]


def _view(seed: int, N: int):
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-8, 8, N), rng.uniform(-2, 2, N),
              rng.uniform(4, 40, N)]
    f, cx, cy = 718.856, 607.1928, 185.2157
    th = rng.uniform(-0.05, 0.05)
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)]])

    def proj(P):
        return np.c_[f * P[:, 0] / P[:, 2] + cx, f * P[:, 1] / P[:, 2] + cy]

    p1 = proj(X) + rng.normal(0, 0.2, (N, 2))
    p2 = proj(X @ rot.T + [0.05, 0.01, -0.8]) + rng.normal(0, 0.2, (N, 2))
    out = rng.choice(N, N // 5, replace=False)
    p2[out] += rng.uniform(15, 40, (len(out), 2)) * rng.choice([-1, 1], (len(out), 2))
    return p1, p2


def case(seed: int, E: int, N: int, kind: str, dev):
    """(p1 [E,N,2], p2 [E,N,2], mask [N]) on `dev`."""
    views = [_view(seed * 7 + e, N) for e in range(E)]
    mask = np.zeros(N, bool)
    rng = np.random.default_rng(seed + 1000)
    mask[rng.choice(N, n_valid(kind, N), replace=False)] = True
    t = lambda a: torch.tensor(np.stack(a), dtype=torch.float32, device=dev)  # noqa: E731
    return (t([v[0] for v in views]), t([v[1] for v in views]),
            torch.from_numpy(mask).to(dev))


def frame_keys(seed: int, dev) -> rrandom.FrameKeys:
    """The engine's keys of a flat filter on frame `seed`."""
    return rrandom.FrameKeys(torch.tensor(seed, dtype=torch.int32, device=dev),
                             1000)


def sampson(F, p1, p2):
    """Squared Sampson distances [E,N] of the pairs to F [E,3,3] in
    float64."""
    return R._sampson_sq(F.double(), p1.double(), p2.double())


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaNs too: a degenerate sample's model is NaN)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def compare(got, probe, want, p1, p2, mask, keys, H) -> dict:
    """Hold the kernel's result `got` (RansacResult) and intermediates
    `probe` (kernels.ransac.ransac_probe) to the plain path's `want` on the
    same inputs (see the module's docstring); `keys` [E,2] the eyes' keys.
    Returns what was measured."""
    u = rrandom.uniform(keys, (H, 8))
    assert bits_equal(probe["draws"], u), "draws"
    assert torch.equal(probe["idx"].long(), R.sample_indices(mask, u)), "indices"
    _, T1 = R._normalize_pts(p1, mask)
    _, T2 = R._normalize_pts(p2, mask)
    assert bits_equal(probe["T1"], T1), (probe["T1"], T1)
    assert bits_equal(probe["T2"], T2), (probe["T2"], T2)
    M = probe["M"].reshape(-1, 9, 9).contiguous()
    assert bits_equal(probe["x"].reshape(-1, 9), nullvec9_cuda(M)), \
        "null vectors against kernel 4"
    assert torch.equal(got.ok, want.ok), (got.ok, want.ok)
    gap = (got.n_inliers - want.n_inliers).abs().max().item()
    assert gap <= COUNT_SLACK, (got.n_inliers, want.n_inliers)
    out = dict(count_gap=gap, best=probe["best"].tolist(),
               n_inliers=got.n_inliers.tolist(),
               plain_n_inliers=want.n_inliers.tolist())
    a = got.F / got.F.abs().amax((-1, -2), keepdim=True)
    b = want.F / want.F.abs().amax((-1, -2), keepdim=True)
    dF = torch.minimum((a - b).abs().amax((-1, -2)), (a + b).abs().amax((-1, -2)))
    dF = torch.where(got.ok, dF, torch.zeros_like(dF))
    assert dF.max().item() <= F_RTOL, dF
    out["F_rel"] = dF.max().item()
    differ = got.inliers != want.inliers
    thr2 = THRESHOLD * THRESHOLD
    edge = torch.minimum((sampson(got.F, p1, p2) - thr2).abs(),
                         (sampson(want.F, p1, p2) - thr2).abs())
    far = differ & (edge > EDGE_PX2)
    assert not far.any(), (int(far.sum()), edge[far])
    out["inliers_differ"] = int(differ.sum())
    out["edge_px2"] = edge[differ].max().item() if differ.any() else 0.0
    return out
