"""The flow path's ATE under three orders of the RANSAC normalisation sum,
on the CPU: the port's flow path (synthetic_config() with ifm_method=3) over
chip_smoke.py's bench frames (1241x376, 2000 points, speed 0.8), its ATE
as chip_smoke computes it, once a sum:

    torch     torch's sum, the port's CPU path (the reference's bits)
    pairwise  ransac._pairwise_sum, the order the port takes on the GPU
    f64       the sum accumulated in float64

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_flow_order.py \
        [--frames 20] [--seeds 0 1 2]

One line a seed and sum: valid frames and ATE (about a minute a run at one
torch thread).  The card's flow ATE is the GPU order's, not the card's: a
float32 8-point near-tie in the per-octave RANSAC that the order tips either
way (ROADMAP, "Held by tests").  Imports no jax.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def sums() -> dict:
    """name -> a `_sum_points(x, dim)`."""
    from rso_torch.solver.ransac import _pairwise_sum

    return {
        "torch": lambda x, dim: x.sum(dim),
        "pairwise": lambda x, dim: _pairwise_sum(x.movedim(dim, -1)),
        "f64": lambda x, dim: x.double().sum(dim).to(x.dtype),
    }


def flow_run(n_frames: int, seed: int, sum_points) -> dict:
    """The flow path over the first n_frames bench frames of `seed` on the
    CPU with ransac._sum_points replaced by `sum_points`."""
    import _torch_card as card
    import rso_torch.solver.ransac as ransac
    from rso_torch.engine import Engine
    from rso_torch.synthetic import synthetic_config

    base = synthetic_config()
    cfg = base.replace(if_match=dataclasses.replace(base.if_match,
                                                    ifm_method=3))
    seq = card.bench_scene(max(n_frames, card.N_FRAMES), seed=seed)
    keep, ransac._sum_points = ransac._sum_points, sum_points
    try:
        eng = Engine(cfg, seq.cam, device="cpu")
        results = [eng.process_frame(left, right)
                   for left, right in seq.frames[:n_frames]]
    finally:
        ransac._sum_points = keep
    return {"valid": sum(bool(r.valid) for r in results),
            "ate": float(card.ate(results, seq.poses))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    torch.set_num_threads(1)
    for seed in args.seeds:
        for name, fn in sums().items():
            out = flow_run(args.frames, seed, fn)
            print(json.dumps(dict(seed=seed, sum=name, frames=args.frames,
                                  **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
