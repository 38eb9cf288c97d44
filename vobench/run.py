"""Run one cell of BENCHMARK.json once and print its result line.

    python3 vobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (configs/<name>.json, beside its frozen INI
preset) and a traffic mix (traffic/<name>.json); each per-layer metric has
its reader in metrics/<name>.py. The run renders its laps from the seed on
the device, builds the program and warms it on the stream's first frames
(set-up), measures for --seconds, then, with --trace 1, profiles a fixed
slice of further frames. Once the window has closed and the program is
freed, a sample of the window's frames is judged against the plain
reference (judge.py). The last line of standard output is one JSON object;
the numbers compared, each beside its limit, are the last lines of standard
error and the last key of that object.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every cache of the program inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / "build" / "vobench" / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "rso")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `rso_torch` is not `rso`."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def load_cell(bench: dict, name: str) -> dict:
    """Everything a cell needs, found by the names in BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = json.loads((BENCH_DIR / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())

    def here(m):
        return "workloads" not in m or name in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if here(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if here(m) and ("workloads" in m or m["moves"] in names)]
    return dict(cell=w, cfg=cfg, traffic=traffic, end_to_end=e2e,
                per_layer=layer,
                ini=str(BENCH_DIR / "configs" / cfg["ini"]))


def end_to_end(spec: list, rec, setup_s: float) -> dict:
    """The cell's end-to-end metrics from what the window saw."""
    from vobench import stats

    out = {}
    for m in spec:
        name = m["name"]
        if name == "setup_s":
            v = setup_s
        elif name == "frames_per_s":
            v = stats.rate(rec.window_frames, rec.window_s)
        elif name == "frame_ms_p95":
            v = stats.percentile(rec.latency_ms, 95)
        else:
            raise SystemExit(f"no arithmetic for end-to-end metric {name!r}")
        out[name] = {"value": v, "unit": m["unit"]}
    return out


def per_layer(spec: list, rec, c: dict) -> dict:
    """Each per-layer metric from its reader, metrics/<name>.py; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in spec:
        mod = importlib.import_module(f"vobench.metrics.{m['name']}")
        v = mod.read(rec, c)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _widest(rows: list) -> list:
    return [tuple(round(x, 4) for x in r) for r in sorted(rows)[-10:]]


def say(msg: str) -> None:
    print(f"vobench: {msg}", file=sys.stderr, flush=True)


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device,
             fault=None, t_start: float = T_START, control: bool = False
             ) -> dict:
    """One run of the cell `c` (load_cell's) on `device`. Returns the result
    object, checks last. `fault` breaks the timed path (drive.Fault);
    `control` adds the lower-precision control's checks on the same
    frames."""
    import numpy as np
    import torch

    from vobench import drive, judge

    cuda = torch.device(device).type == "cuda"
    t = c["traffic"]
    t0 = time.perf_counter()
    laps, poses = drive.render_laps(c["cfg"], drive.lane_seeds(t, seed),
                                    int(t.get("chunk", 0)), device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    d = drive.Driver(t, c["cfg"], c["ini"], laps, device, drive.Fault(fault))
    t2 = time.perf_counter()
    d.warm()
    setup_s = time.perf_counter() - t_start
    say(f"set-up {setup_s:.2f} s: imports and CUDA {t0 - t_start:.2f}, laps "
        f"{t1 - t0:.2f}, program {t2 - t1:.2f}, warm frames "
        f"{time.perf_counter() - t2:.2f}")
    d.window(seconds)
    events = None
    if trace:
        events, slice_s, slice_frames = d.traced(int(t["trace_units"]))
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec = d.finish()
    del d
    if cuda:
        torch.cuda.empty_cache()
    ref = judge.Reference(c["cfg"], device)
    gt = ref.ground_truth(poses)
    finite = [bool(np.all(np.isfinite(p))) for lane in rec.poses for p in lane]
    result = {"correct": False, "attempted": len(finite),
              "failed": finite.count(False), "metrics": {}}
    if trace:
        from vobench import trace as tr
        t_red = time.perf_counter()
        rec.trace = tr.reduce(*events, slice_s)
        del events
        if rec.trace is not None:
            say(f"trace: {slice_frames} frames in {slice_s:.3f} s "
                f"({slice_s / slice_frames * 1e3:.3f} ms a frame; the window "
                f"{rec.window_s / rec.window_frames * 1e3:.3f}), reduced in "
                f"{time.perf_counter() - t_red:.2f} s; launches by kernel "
                f"{rec.trace.kernel_n}")
        result["metrics"] = per_layer(c["per_layer"], rec, c)
    else:
        result["metrics"] = end_to_end(c["end_to_end"], rec, setup_s)
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": int(c["cell"]["chips"]), "memory_peak_bytes": int(memory_peak)}
    if trace and rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops,
                               "idle_gaps": rec.trace.idle_gaps}
    pairs = judge.sample(rec, int(t["sample_pairs"]), seed)
    truth = judge.true_motions(gt, pairs)
    t_judge = time.perf_counter()
    got = judge.judge(rec, c["cfg"], laps, pairs, device, truth)
    say(f"judge: {len(pairs)} pairs in {time.perf_counter() - t_judge:.2f} s; "
        "the widest ten (gap to the reference, the program's and the "
        f"reference's gaps to the truth, px): {_widest(got.pop('diag'))}")
    if control:
        result["control"] = judge.control(c["cfg"], laps, pairs, device, truth)
        say(f"control: the widest ten {_widest(result['control'].pop('diag'))}")
    lim = judge.limits(BENCH_DIR, c["cell"]["name"])
    say(f"judged {got['judged']} of {len(pairs)} sampled frames, "
        f"{got['lost']} of them not valid in the program only")
    checks = {k: {"value": got[k], "limit": lim[k]} for k in judge.CHECKS}
    result["correct"] = (result["failed"] == 0
                         and all(v["value"] <= v["limit"] for v in checks.values()))
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    c = load_cell(bench, a.workload)
    import torch

    chips = int(c["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vobench: {a.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(c, a.seed, a.seconds, bool(a.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"vobench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
