"""How many PyTorch operations one LM iteration of rso_torch.ba issues.

    python3 tests/_torch_ba_ops.py

On the CPU (no jax, no card needed): bundle_adjust on chip_smoke.py's bench
BA problem (P = 8, L = 1024) at tol=0, with 1 and with 2 iterations, under
a dispatch mode that counts every aten call; the difference is one
iteration's count, without and with the odometry prior (VOWithBA's
solves).  The host issues each of these, so on the card an iteration's
time is about this count times the host's cost of an operation.
"""
import collections
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import _torch_card as card  # noqa: E402
from rso_torch.ba import bundle_adjust  # noqa: E402


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


def ops_per_iteration(**kw) -> collections.Counter:
    seq_cam = card.bench_scene(1).cam
    prob = card.bench_ba_problem(seq_cam, torch.device("cpu"))
    counts = []
    for n in (1, 2):
        with CountOps() as c:
            bundle_adjust(seq_cam, prob, max_iters=n, tol=0.0, **kw)
        counts.append(c.counts)
    return counts[1] - counts[0]


if __name__ == "__main__":
    prior = dict(rel_meas=torch.zeros(7, 6), rel_w_rot=4e2, rel_w_trans=25.0)
    for name, kw in (("plain", {}), ("odometry prior", prior)):
        d = ops_per_iteration(**kw)
        print(f"{name}: {sum(d.values())} operations an iteration; most "
              f"frequent {d.most_common(8)}")
