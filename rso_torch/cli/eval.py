"""rso-eval: evaluate a trajectory file against ground truth (ATE/RPE).

Counterpart of rso/cli/eval.py (same arguments and output).  The evaluation
is host numpy; like every entry point of this package it takes a device,
the GPU by default, and raises where CUDA is absent."""
from __future__ import annotations

import argparse
import sys


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser("rso-eval", description=__doc__)
    p.add_argument("estimate", help="estimated trajectory (KITTI or TUM format)")
    p.add_argument("ground_truth", help="ground-truth trajectory")
    p.add_argument("--tum", action="store_true", help="inputs are TUM format")
    p.add_argument("--align-scale", action="store_true", help="Sim(3) alignment")
    p.add_argument("--rpe-delta", type=int, default=1)
    args = p.parse_args(argv)

    from rso_torch.engine import _device
    from rso_torch.io.trajectory import read_kitti, read_tum
    from rso_torch.metrics.ate import ate_rmse, rpe

    _device(device)
    if args.tum:
        _, est = read_tum(args.estimate)
        _, gt = read_tum(args.ground_truth)
    else:
        est = read_kitti(args.estimate)
        gt = read_kitti(args.ground_truth)
    n = min(len(est), len(gt))
    a = ate_rmse(est[:n], gt[:n], with_scale=args.align_scale)
    rt, rr = rpe(est[:n], gt[:n], delta=args.rpe_delta)
    print(f"ATE RMSE: {a:.4f} m")
    print(f"RPE({args.rpe_delta}): {rt:.4f} m / {rr:.4f} deg")
    return 0


if __name__ == "__main__":
    sys.exit(main())
