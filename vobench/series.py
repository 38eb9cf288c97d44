"""Run cells several times, one process a run, and summarise the spread.

    python3 vobench/series.py --workload kitti.live --seeds 11,12,13 \
        --seconds 20 [--trace 0] [--sets 2] [--out DIR]

Each run is `run.py` in its own process, one after another, so that one
process uses the card at a time. Every result line goes to
DIR/<workload>.jsonl (default chiprun_out/series) with its seed, set and
exit code, and the end of each run's standard error beside it. The summary
gives each metric's median and its spread: the distance between the first
and third quartiles (statistics.quantiles, n=4) over the median, per set,
the figure a bound is set from.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values: list) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med) if med else float("inf")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default=str(HERE.parent / "chiprun_out" / "series"))
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    rc_all = 0
    for w in a.workload:
        rows = []
        with open(out / f"{w}.jsonl", "a") as f:
            for s_i in range(a.sets):
                for seed in seeds:
                    t0 = time.perf_counter()
                    p = subprocess.run(
                        [sys.executable, str(HERE / "run.py"), "--workload", w,
                         "--seed", str(seed), "--seconds", str(a.seconds),
                         "--trace", str(a.trace)],
                        capture_output=True, text=True)
                    wall = time.perf_counter() - t0
                    line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
                    try:
                        res = json.loads(line)
                    except json.JSONDecodeError:
                        res = None
                    rc_all |= p.returncode
                    rows.append((s_i, seed, res))
                    f.write(json.dumps({"workload": w, "set": s_i, "seed": seed,
                                        "rc": p.returncode, "wall_s": wall,
                                        "result": res,
                                        "stderr_tail": p.stderr[-3000:]}) + "\n")
                    f.flush()
                    brief = ({k: round(v["value"], 4) for k, v in res["metrics"].items()}
                             if res else p.stderr[-800:])
                    checks = ({k: v["value"] for k, v in res["checks"].items()}
                              if res else None)
                    print(f"{w} set {s_i} seed {seed} rc {p.returncode} "
                          f"wall {wall:.1f}s correct {res and res['correct']} "
                          f"{brief} checks {checks}", flush=True)
        for s_i in range(a.sets):
            got = [r for i, _, r in rows if i == s_i and r]
            if len(got) < 2:
                continue
            for name in got[0]["metrics"]:
                vals = [r["metrics"][name]["value"] for r in got
                        if name in r["metrics"]]
                if len(vals) >= 2:
                    print(f"{w} set {s_i} {name}: median "
                          f"{statistics.median(vals)!r} spread "
                          f"{spread(vals) if len(vals) >= 2 else 'n/a'!r} "
                          f"values {vals}", flush=True)
    return rc_all


if __name__ == "__main__":
    sys.exit(main())
