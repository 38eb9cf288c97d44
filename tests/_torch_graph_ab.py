"""Two trees of rso_torch on one card, in turns: the step and solve times of
the block form (graphs replayed a block at a time, the host reading the
loops' flags) against the one-launch form (conditional nodes), or any two
versions of the compiled step.

    python3 tests/_torch_graph_ab.py --parent-root DIR [--frames 20]

DIR holds another checkout of the repository (e.g. `git archive REV` unpacked
into build/ab_parent; the copy on the GPU host has no .git).  Each tree runs
in a process of its own, in the order parent, this tree, this tree,
parent, and prints one JSON line; each builds its own kernels under its own
root.  Per tree, on the bench scene (1241x376, 2000 points, speed 0.8, the
bench camera), with CUDA events around each call and medians after a
warm-up that captures:

  default    Engine(synthetic_config()), ms a step over `frames` frames
  eigh_lm    the eigh backend with LM damping, 10 frames
  batched    BatchEngine of 11 sequences (seeds 0-10), ms a batched step
  ba         bundle_adjust(max_iters=15) on the bench BA problem (P 8,
             L 1024), ms a replayed solve over 20 calls

and the host reads a frame (a solve) of each, from robust_gn.HOST_READS.
Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
H, W = 376, 1241


def _events_ms(fn, n):
    import torch

    out = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        out.append((a, b))
    torch.cuda.synchronize()
    t = sorted(a.elapsed_time(b) for a, b in out)
    return t[len(t) // 2]


def measure(root: Path, n_frames: int) -> dict:
    sys.path.insert(0, str(root))
    import dataclasses

    import torch

    from rso_torch.ba import bundle_adjust
    from rso_torch.cli.bench import bench_ba_problem
    from rso_torch.engine import Engine
    from rso_torch.geometry import StereoCamera
    from rso_torch.parallel import BatchEngine
    from rso_torch.solver.robust_gn import HOST_READS
    from rso_torch.synthetic import make_sequence, synthetic_config

    dev = torch.device("cuda")
    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=W / 2.0,
                            cy_l=H / 2.0, baseline=0.5371)
    seqs = [make_sequence(n_frames=n_frames, n_points=2000, H=H, W=W, cam=cam,
                          speed=0.8, seed=s) for s in range(11)]
    frames = [(torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev))
              for l, r in seqs[0].frames]
    base = synthetic_config()
    out = {"root": str(root)}
    for name, cfg, n in (
            ("default", base, n_frames),
            ("eigh_lm", base.replace(least_squares=dataclasses.replace(
                base.least_squares, solve_backend="eigh", use_lm=True)), 10)):
        eng = Engine(cfg, cam)
        for left, right in frames[:3]:
            eng.process_frame(left, right)
        eng.reset()
        HOST_READS.clear()
        it = iter(frames[:n])
        ms = _events_ms(lambda: eng.process_frame(*next(it)), n)
        out[name] = {"ms": ms, "reads_per_frame": sum(HOST_READS.values()) / n}
    lefts = torch.stack([torch.stack([torch.from_numpy(f[0]) for f in s.frames])
                         for s in seqs]).to(dev)
    rights = torch.stack([torch.stack([torch.from_numpy(f[1]) for f in s.frames])
                          for s in seqs]).to(dev)
    be = BatchEngine(base, cam, batch=11, img_h=H, img_w=W)
    start = be.states
    be.process_frames(lefts[:, 0], rights[:, 0])
    be.states = start
    HOST_READS.clear()
    it = iter(range(n_frames))

    def batched():
        i = next(it)
        be.process_frames(lefts[:, i], rights[:, i])

    out["batched"] = {"ms": _events_ms(batched, n_frames),
                      "reads_per_frame": sum(HOST_READS.values()) / n_frames}
    prob = bench_ba_problem(cam.to(dev), dev)
    for _ in range(2):
        bundle_adjust(cam.to(dev), prob, max_iters=15)
    HOST_READS.clear()
    out["ba"] = {"ms": _events_ms(
        lambda: bundle_adjust(cam.to(dev), prob, max_iters=15), 20),
        "reads_per_solve": sum(HOST_READS.values()) / 20}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-root")
    ap.add_argument("--measure")
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.measure:
        print(json.dumps(measure(Path(args.measure).resolve(), args.frames)),
              flush=True)
        return 0
    parent = Path(args.parent_root).resolve()
    runs = []
    for root in (parent, REPO, REPO, parent):
        proc = subprocess.run(
            [sys.executable, __file__, "--measure", str(root), "--frames",
             str(args.frames)], capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; order parent, change, change, parent", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
