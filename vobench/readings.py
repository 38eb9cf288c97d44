"""The readings a cell's limits are set from, in one process.

    python3 vobench/readings.py --workload kitti.live --seeds 1,2,3 \
        --seconds 4 [--control 1]

For each seed: one run of the cell (as run.py makes it, with a window of
--seconds), the program's checks against the reference; with --control 1
also the lower-precision control's (the reference in bfloat16 put in the
program's place) on the same frames. One JSON line a seed on standard
output, then each check's largest program reading and smallest control
reading over the seeds.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vobench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=0)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    c = run.load_cell(bench, a.workload)
    c["end_to_end"] = []
    prog, ctrl = {}, {}
    for seed in (int(s) for s in a.seeds.split(",")):
        res = run.run_cell(c, seed, a.seconds, False, "cuda",
                           t_start=time.perf_counter(), control=bool(a.control))
        row = {"workload": a.workload, "seed": seed, "correct": res["correct"],
               "program": {k: v["value"] for k, v in res["checks"].items()},
               "control": res.get("control"), "failed": res["failed"]}
        print(json.dumps(row), flush=True)
        for k, v in row["program"].items():
            prog[k] = max(prog.get(k, v), v)
        for k, v in (row["control"] or {}).items():
            ctrl[k] = min(ctrl.get(k, v), v)
    print(json.dumps({"workload": a.workload, "largest_program": prog,
                      "smallest_control": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
