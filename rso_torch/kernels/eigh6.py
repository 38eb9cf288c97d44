"""The pose solver's 6x6 symmetric eigensolver: batched cyclic Jacobi.

No TPU kernel of the reference: rso's eigh solve backend calls XLA's
`jnp.linalg.eigh` (rso/solver/robust_gn.py:133).  On the GPU the GN
iteration kernel runs this routine itself (csrc/eigh6.cuh inside
csrc/gn_iter.cu), since cuSOLVER's eigh checks its status on the host and
so cannot run inside a CUDA graph.  The plain GN iteration
(robust_gn.gn_iteration_torch) takes `torch.linalg.eigh` on the CPU
(LAPACK, the routine XLA runs there) and `eigh6_torch` on the GPU.

`eigh6_torch` runs the routine's arithmetic: the same rotations in the
same order, each a sequence of correctly rounded f32 operations with no
fused multiply-add, so it and csrc/eigh6.cuh agree bit for bit wherever
the compilers keep that order.
"""
from __future__ import annotations

import torch

_N = 6
# cyclic sweeps over the 15 (p, q) pairs, every matrix the same count; a
# pair whose off-diagonal entry is exactly 0 is skipped
SWEEPS = 8
# a sorting network for 6 values (12 compare-exchanges, depth 5): the
# eigenvalues ascending, the eigenvectors (columns) moved with them
SORT_NETWORK = ((0, 5), (1, 3), (2, 4), (1, 2), (3, 4), (0, 3), (2, 5),
                (0, 1), (2, 3), (4, 5), (1, 2), (3, 4))


def eigh6_torch(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., 6, 6] symmetric (the lower triangle is read, as eigh reads it)
    -> (w [..., 6] ascending, V [..., 6, 6] with the eigenvectors as
    columns): SWEEPS cyclic Jacobi sweeps, csrc/eigh6.cuh's arithmetic."""
    one = torch.ones_like(H[..., 0, 0])
    zero = torch.zeros_like(one)
    a = [[H[..., max(i, j), min(i, j)] for j in range(_N)] for i in range(_N)]
    v = [[one if i == j else zero for j in range(_N)] for i in range(_N)]
    for _ in range(SWEEPS):
        for p in range(_N - 1):
            for q in range(p + 1, _N):
                _rotate(a, v, p, q, one)
    w = [a[i][i] for i in range(_N)]
    cols = [[v[r][k] for r in range(_N)] for k in range(_N)]
    for i, j in SORT_NETWORK:
        swap = w[j] < w[i]
        w[i], w[j] = (torch.where(swap, w[j], w[i]),
                      torch.where(swap, w[i], w[j]))
        cols[i], cols[j] = ([torch.where(swap, y, x) for x, y in
                             zip(cols[i], cols[j])],
                            [torch.where(swap, x, y) for x, y in
                             zip(cols[i], cols[j])])
    V = torch.stack([torch.stack(col, -1) for col in cols], -1)
    return torch.stack(w, -1), V


def _rotate(a, v, p: int, q: int, one) -> None:
    """One Jacobi rotation zeroing a[p][q] (Golub and Van Loan's
    sym.schur2), in place on the lists of tensors; skipped where a[p][q] is
    0.  theta's square overflows to inf for |theta| > ~1e19, giving t = 0:
    the entry is dropped, as it is below the diagonal's rounding."""
    apq, app, aqq = a[p][q], a[p][p], a[q][q]
    rot = apq != 0
    theta = (aqq - app) / (apq * 2.0)
    at = theta.abs()
    t = one / (at + torch.sqrt(at * at + one))
    t = torch.where(theta < 0, -t, t)
    c = one / torch.sqrt(t * t + one)
    s = t * c

    def keep(new, old):
        return torch.where(rot, new, old)

    a[p][p] = keep(app - t * apq, app)
    a[q][q] = keep(aqq + t * apq, aqq)
    a[p][q] = a[q][p] = keep(torch.zeros_like(apq), apq)
    for r in range(_N):
        if r in (p, q):
            continue
        arp, arq = a[r][p], a[r][q]
        a[r][p] = a[p][r] = keep(c * arp - s * arq, arp)
        a[r][q] = a[q][r] = keep(s * arp + c * arq, arq)
    for r in range(_N):
        vrp, vrq = v[r][p], v[r][q]
        v[r][p] = keep(c * vrp - s * vrq, vrp)
        v[r][q] = keep(s * vrp + c * vrq, vrq)
