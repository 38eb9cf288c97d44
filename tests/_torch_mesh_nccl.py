"""The mesh forms' compiled solve on an NCCL group over several cards, one
rank a card: the all_reduces captured inside the solve's CUDA graph between
cards, where a one-rank group's all_reduce is no node at all.

    python3 tests/_torch_mesh_nccl.py [--ranks 4] [--tag NAME]
        [--block-form] [--cpu]

Starts RANKS processes of this script (a FileStore in
build/chip_smoke/mesh_nccl), rank r on card r, each:
  (a) distributed_bundle_adjust on chip_smoke's bench BA problem (P 8,
      L 1024, 15 iterations) over a RANKS-rank 'lmk' mesh: the eager mesh
      loop (chip_smoke.eager_mesh_solves), the compiled solve's first call
      (warm-up and capture) and a replay, both equal to the eager loop bit
      for bit; a replay one graph launch with no LM host read and 1 + 2 n
      solve all_reduces (n the iterations the loop ran) and one gather;
      the node types of the captured segments; the one-device
      bundle_adjust held to chip_smoke's phase-9 bounds; BA iterations/s
      (25-75 iteration slope) of the compiled solve and of the eager loop;
  (b) three windows (tests/test_torch_cuda.py's) on a (2, RANKS/2)
      ('win','lmk') mesh, the same way: compiled against eager bit for bit,
      a replay one graph launch with no LM host read, and against the
      one-device batch at phase 9's window bounds.
The form each captured solve took (`_Composed`, one launch with WHILE
nodes; `_Blocks`, a launch a segment and a flag read a block, where a
block holds nodes no conditional body takes) is reported; a replay in the
block form is held to the eager loop's flag reads and to one launch a
segment and a block.  --block-form empties rso_torch.graphs._BODY_TYPES in
the ranks, so every solve takes the block form.
Every rank writes its results, and its log (progress, NCCL's
initialisation, and its Python stack if it outlives RANK_TIMEOUT) to
chiprun_out/mesh_nccl/<tag>/rank<R>.log (NCCL's bootstrap over loopback:
NCCL_SOCKET_IFNAME=lo unless set); a rank that fails exits at once, without
NCCL's teardown;
this process holds every rank's (a) and its 'win' row's (b) to rank 0's
(row's first rank's) bits, prints each log and one JSON line a rank, and
exits non-zero where a check failed or a rank did not end in time.  --cpu
rehearses on gloo ranks on the CPU (one torch thread each), where the
solve runs eagerly by rule, so the graph checks are skipped.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WORK = REPO / "build" / "chip_smoke" / "mesh_nccl"
LOGS = REPO / "chiprun_out" / "mesh_nccl"
MAX_ITERS = 15
WIN_KW = dict(max_iters=MAX_ITERS, tol=1e-4)
RANK_TIMEOUT = 120


def _compiled_vs_eager(what, solve, cpu, step, rows=None):
    """(eager, replay counts, captured graphs) of solve(): the eager mesh
    loop, then the compiled solve's first call and a replay, both held to
    the eager answer bit for bit; `rows` the windows of this rank's row,
    step(text) logs progress."""
    import chip_smoke as CS
    import rso_torch.ba.ba as B
    from rso_torch.solver.robust_gn import HOST_READS

    HOST_READS.clear()
    with CS.eager_mesh_solves():
        eager = solve()
    eager_reads = HOST_READS["lm"]
    step(f"{what} eager loop done")
    n_graphs = CS._n_solve_graphs(B)
    first = solve()
    captured = CS._n_solve_graphs(B) - n_graphs
    step(f"{what} first compiled call done ({captured} graphs captured)")
    got, counts = CS.counted_solve(solve)
    many = isinstance(eager, list)
    for call, out in (("first call", first), ("replay", got)):
        for w, (a, b) in enumerate(zip(out if many else [out],
                                       eager if many else [eager])):
            CS._same_bits(f"{what} {call} window {w} vs the eager loop", a, b)
    n_iters = (max(int(got[w].n_iters) for w in rows) if many
               else int(got.n_iters))
    n = CS._lm_loop_iterations(n_iters, MAX_ITERS)
    want = {"solve lmk": 1 + 2 * n, "gather lmk": 1}
    if many:
        want["gather win"] = 1
    if counts["collectives"] != want:
        raise AssertionError(f"{what}: collectives {counts['collectives']}, "
                             f"expected {want}")
    forms = {f for f, _ in CS.mesh_solve_forms(B)}
    if cpu:
        pass
    elif forms == {"_Composed"}:
        if (counts["graph_launches"], counts["lm_reads"]) != (1, 0):
            raise AssertionError(f"{what}: a replay made {counts}, expected "
                                 "one graph launch and no LM host read")
    elif forms == {"_Blocks"}:
        # pre, tail and one launch a block; the eager loop's flag reads
        if (counts["graph_launches"], counts["lm_reads"]) != (
                2 + n // min(B.LM_BLOCK, MAX_ITERS), eager_reads):
            raise AssertionError(f"{what}: a replay in the block form made "
                                 f"{counts}, the eager loop {eager_reads} "
                                 "reads")
    else:
        raise AssertionError(f"{what}: forms {forms}")
    counts.pop("launches")
    return eager, counts, captured


def _step(rank: int, what: str) -> None:
    print(f"rank {rank}: {what} at {time.strftime('%H:%M:%S')}", flush=True)


def rank_main(rank: int, world: int, cpu: bool, block_form: bool) -> None:
    faulthandler.dump_traceback_later(RANK_TIMEOUT, exit=True)
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    import torch
    import torch.distributed as dist

    import rso_torch.graphs as graphs

    if block_form:
        graphs._BODY_TYPES = frozenset()

    import chip_smoke as CS
    import rso_torch.ba.ba as B
    from rso_torch.ba import (bundle_adjust, distributed_bundle_adjust,
                              make_mesh, make_win_mesh,
                              window_sharded_bundle_adjust)
    from rso_torch.ba.multihost import initialize_multihost
    from rso_torch.cli.bench import ba_slope
    from test_torch_cuda import BA_CAM, _ba_problem

    if cpu:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        from rso_torch.kernels import _lib

        _lib.load()
    _step(rank, "library loaded")
    initialize_multihost(f"file://{WORK}/store", world, rank,
                         backend="gloo" if cpu else "nccl")
    _step(rank, "group started")
    ones = torch.ones(4, device=dev)
    dist.all_reduce(ones)
    _step(rank, f"first all_reduce: {ones.tolist()}")
    out = {"rank": rank, "backend": dist.get_backend(),
           "device": "cpu" if cpu else torch.cuda.get_device_name(rank),
           "torch": torch.__version__,
           "nccl": None if cpu else list(torch.cuda.nccl.version())}

    # (a) the bench problem's landmarks split `world` ways
    cam = CS._bench_cam().to(dev)
    prob = CS._bench_ba_problem(cam, dev)
    mesh = make_mesh(device=dev.type)

    def solve(**kw):
        return distributed_bundle_adjust(cam, prob, mesh,
                                         **dict(dict(max_iters=MAX_ITERS), **kw))

    eager, out["ba_replay"], out["ba_graphs"] = _compiled_vs_eager(
        f"rank {rank} (a)", solve, cpu, lambda w: _step(rank, w))
    _step(rank, f"(a) compiled solve replayed: {out['ba_replay']}; forms "
                f"and node types {CS.mesh_solve_forms(B) if not cpu else []}")
    one = CS._to_cpu(bundle_adjust(cam, prob, max_iters=MAX_ITERS))
    k = CS._parted_at(eager, one)
    CS._hold_solve(f"rank {rank} (a) vs one device", eager, one,
                   None if k is None else [solve(max_iters=k),
                                           bundle_adjust(cam, prob,
                                                         max_iters=k)],
                   lambda p, l: bundle_adjust(cam, prob._replace(
                       poses=p.to(dev), lmks=l.to(dev)), max_iters=0).cost)
    out["ba"] = CS._to_cpu(eager)
    rate = ba_slope(cam, prob, solve=lambda c, p, **kw: solve(**kw))
    with CS.eager_mesh_solves():
        eager_rate = ba_slope(cam, prob, solve=lambda c, p, **kw: solve(**kw))
    out["iters_per_sec"] = {"compiled": rate["iters_per_sec"],
                            "eager": eager_rate["iters_per_sec"]}
    _step(rank, f"(a) iterations/s {out['iters_per_sec']}")

    # (b) three windows on a (2, world/2) ('win','lmk') mesh
    probs = [CS._problem_to(_ba_problem(s, noise=n), dev)
             for s, n in ((21, 0.2), (22, 0.2), (23, 0.0))]
    wcam = BA_CAM.to(dev)
    wmesh = make_win_mesh(2, world // 2, device=dev.type)
    row = wmesh.get_local_rank("win")
    rows = [w for w in range(3) if w // 2 == row]

    def wsolve(**kw):
        return window_sharded_bundle_adjust(wcam, probs, wmesh,
                                            **dict(WIN_KW, **kw))

    weager, out["win_replay"], out["win_graphs"] = _compiled_vs_eager(
        f"rank {rank} (b)", wsolve, cpu, lambda w: _step(rank, w), rows)
    _step(rank, f"(b) compiled solve replayed: {out['win_replay']}")
    batch = [CS._to_cpu(r) for r in window_sharded_bundle_adjust(
        wcam, probs, **WIN_KW)]
    for w in range(3):
        k = CS._parted_at(weager[w], batch[w])
        CS._hold_solve(
            f"rank {rank} (b) window {w} vs the batch", weager[w], batch[w],
            None if k is None else [
                wsolve(max_iters=k)[w],
                window_sharded_bundle_adjust(wcam, probs, **dict(
                    WIN_KW, max_iters=k))[w]],
            lambda p, l, w=w: bundle_adjust(wcam, probs[w]._replace(
                poses=p.to(dev), lmks=l.to(dev)), max_iters=0).cost,
            pose_atol=CS.BA_WINDOW_POSE_ATOL, lmk_atol=CS.BA_WINDOW_LMK_ATOL)
    out["win"] = [CS._to_cpu(r) for r in weager]
    out["win_row"] = row
    out["forms"] = [] if cpu else CS.mesh_solve_forms(B)
    dist.destroy_process_group()
    torch.save(out, WORK / f"rank{rank}.pt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--tag", default="default")
    ap.add_argument("--block-form", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        try:
            rank_main(args.rank, args.ranks, args.cpu, args.block_form)
        except BaseException:
            traceback.print_exc()
            sys.stdout.flush()
            os._exit(1)     # no NCCL teardown after a failure: it can hang
        return 0
    import shutil

    import torch

    if not args.cpu and torch.cuda.device_count() < args.ranks:
        print(f"{args.ranks} ranks need {args.ranks} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 1
    logs_dir = LOGS / args.tag
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.rmtree(logs_dir, ignore_errors=True)
    WORK.mkdir(parents=True)
    logs_dir.mkdir(parents=True)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--ranks",
           str(args.ranks)] + (["--cpu"] if args.cpu else []) + (
        ["--block-form"] if args.block_form else [])
    logs = [logs_dir / f"rank{r}.log" for r in range(args.ranks)]
    # one host: NCCL's bootstrap over loopback, its initialisation logged
    env = dict(os.environ)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_DEBUG", "INFO")
    env.setdefault("NCCL_DEBUG_SUBSYS", "INIT")
    procs = []
    deadline = time.monotonic() + RANK_TIMEOUT + 30
    try:
        for r in range(args.ranks):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    cmd + ["--rank", str(r)], cwd=str(REPO), stdout=f,
                    stderr=subprocess.STDOUT, env=env))
        while (any(p.poll() is None for p in procs)
               and time.monotonic() < deadline):
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r, log in enumerate(logs):
        text = log.read_text()
        steps = [x for x in text.splitlines() if x.startswith("rank ")]
        print(f"--- rank {r} (rc {procs[r].returncode}), {log}:\n"
              + "\n".join(steps), flush=True)
        if procs[r].returncode != 0:
            print(text[-2500:], flush=True)
    if failed:
        print(f"ranks {failed} failed", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as CS

    ranks = [torch.load(WORK / f"rank{r}.pt", weights_only=False)
             for r in range(args.ranks)]
    for o in ranks:
        CS._same_bits(f"(a) rank {o['rank']} vs rank 0", o["ba"],
                      ranks[0]["ba"])
        peer = next(p for p in ranks if p["win_row"] == o["win_row"])
        for w, (a, b) in enumerate(zip(o["win"], peer["win"])):
            CS._same_bits(f"(b) rank {o['rank']} window {w} vs rank "
                          f"{peer['rank']}", a, b)
    for o in ranks:
        print(json.dumps({k: v for k, v in o.items()
                          if k not in ("ba", "win")}), flush=True)
    print(f"every rank's (a) equal to rank 0's, every row's (b) to its "
          f"first rank's, bit for bit; {CS._nvidia_smi() if not args.cpu else 'CPU'}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
