"""What the GPU host offers for one-launch CUDA graphs, printed.

    python3 tests/_torch_cond_probe.py

Prints Python's, PyTorch's and its CUDA's versions, nvcc's, and the
card's name, power limit and libcuda version (nvidia-smi), whether this
PyTorch can keep a captured graph's cudaGraph_t
(`CUDAGraph(keep_graph=True)`, `raw_cuda_graph`) and capture into an IF
node (`begin_capture_to_if_node`), then builds rso_torch's library
(csrc/*.cu, the conditional-node helper csrc/graph_cond.cu among them) and
prints ptxas's registers and spills of csrc/gn_iter.cu and
csrc/graph_cond.cu.  Conditional WHILE nodes need CUDA 12.4 or later in
the toolkit and in libcuda.  Then, for the segments a compiled
step captures (a bundle_adjust solve at the bench problem's shape, an
Engine step at 376x1241 with each solve backend, and a one-kernel graph),
the node types of each (cudaGraphNodeType: 0 kernel, 1 memcpy, 2 memset,
3 host, 4 child graph, 5 empty, 6 event wait, 7 event record, 10 memory
allocation, 11 free) and the error code of adding it as a child-graph node
to a graph's top level and to a WHILE node's body.  Exits non-zero without
CUDA.

    python3 tests/_torch_cond_probe.py --nccl

prints NCCL's version and, on a one-rank NCCL group, captures an
all_reduce between two kernels in each capture error mode, prints the
segment's node types and child-node error codes as above, and runs it as
the body of a composed WHILE node (ten iterations); then the same in a
process started with NCCL_GRAPH_MIXING_SUPPORT=0.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _run(cmd) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cmd[0]}: {e}"
    return (out.stdout + out.stderr).strip()


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--nccl"]:
        return _nccl(child=len(sys.argv) > 2)

    sys.path.insert(0, str(REPO))
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from rso_torch.kernels import _lib

    print(_run([_lib._nvcc(), "--version"]).splitlines()[-1], flush=True)
    print("nvidia-smi: " + _run(
        ["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
         "--format=csv,noheader"]), flush=True)
    graph_cls = torch.cuda.CUDAGraph
    try:
        g = graph_cls(keep_graph=True)
        keep = True
    except TypeError:
        g, keep = graph_cls(), False
    print(f"CUDAGraph(keep_graph=True): {keep}; raw_cuda_graph: "
          f"{hasattr(g, 'raw_cuda_graph')}; begin_capture_to_if_node: "
          f"{hasattr(g, 'begin_capture_to_if_node')}", flush=True)
    t0 = time.perf_counter()
    path = _lib.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({path})", flush=True)
    out = REPO / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    for src in ("gn_iter.cu", "graph_cond.cu"):
        log = _run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                    "-o", str(out / (src + ".o")),
                    str(REPO / "rso_torch" / "csrc" / src)])
        print(f"ptxas {src}:\n{log}", flush=True)
    _segments()
    return 0


def _child_rc(raw: int, in_while: bool) -> int:
    """The error code of adding graph `raw` as a child node of a new graph
    (in a WHILE node's body where in_while)."""
    import ctypes

    from rso_torch.kernels import _lib

    lib = _lib.load()
    g, node, body = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
    lib.rso_graph_create(ctypes.byref(g))
    parent = g
    if in_while:
        h = ctypes.c_ulonglong()
        lib.rso_graph_add_handle(g, ctypes.byref(h))
        lib.rso_graph_add_cond(g, None, h, 1, ctypes.byref(node),
                               ctypes.byref(body))
        parent = body
    rc = lib.rso_graph_add_child(parent, None, raw, ctypes.byref(node))
    lib.rso_graph_destroy(g)
    return rc


def _describe(what: str, segments) -> None:
    import ctypes

    from rso_torch.kernels import _lib

    for i, seg in enumerate(segments):
        raw = seg.graph.raw_cuda_graph()
        counts = (ctypes.c_int * 16)()
        rc = _lib.load().rso_graph_node_types(raw, counts, 16)
        types = {t: n for t, n in enumerate(counts) if n}
        print(f"{what} segment {i} ({'loop' if seg.loop else 'plain'}): node "
              f"types {types} (rc {rc}); as a child: top level rc "
              f"{_child_rc(raw, False)}, WHILE body rc {_child_rc(raw, True)}",
              flush=True)


def _mem_node_users(raw: int) -> list:
    """The names of the kernels that depend on each memory-allocation node
    of graph `raw` (through libcuda's graph API)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    class KernelParams(ctypes.Structure):
        _fields_ = [("func", ctypes.c_void_p)] + [
            (n, ctypes.c_uint) for n in ("gx", "gy", "gz", "bx", "by", "bz",
                                         "smem")] + [
            ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
            ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    n = ctypes.c_size_t()
    cu.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    cu.cuGraphGetNodes(ctypes.c_void_p(raw), nodes, ctypes.byref(n))
    out = []
    for node in nodes:
        t = ctypes.c_int()
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        if t.value != 10:
            continue
        m = ctypes.c_size_t()
        cu.cuGraphNodeGetDependentNodes(ctypes.c_void_p(node), None,
                                        ctypes.byref(m))
        deps = (ctypes.c_void_p * m.value)()
        cu.cuGraphNodeGetDependentNodes(ctypes.c_void_p(node), deps,
                                        ctypes.byref(m))
        names = []
        for d in deps:
            p = KernelParams()
            if cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(d),
                                                ctypes.byref(p)) != 0:
                names.append("(not a kernel)")
                continue
            name = ctypes.c_char_p()
            if p.func:
                cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func))
            else:
                cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern))
            names.append((name.value or b"?").decode()[:120])
        out.append(names)
    return out


def _segments() -> None:
    """Capture, without composing, and describe the segments."""
    import dataclasses

    import numpy as np
    import torch

    import rso_torch.graphs as graphs
    from rso_torch.ba import bundle_adjust
    from rso_torch.ba.ba import BAProblem
    from rso_torch.engine import Engine
    from rso_torch.geometry import StereoCamera
    from rso_torch.synthetic import make_sequence, synthetic_config

    seen = []

    class Describe:
        def __init__(self, graphs_, pred, flags, site):
            seen.append((site, graphs_, pred))
            raise _Stop

    class _Stop(Exception):
        pass

    graphs._Composed = Describe
    dev = torch.device("cuda")
    # a one-kernel graph
    x = torch.zeros(4, device=dev)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        x.add_(1.0)
    _describe("x.add_(1)", [graphs._Segment(g, {}, None)])
    # bundle_adjust at the bench problem's shape (P 8, L 1024)
    r = np.random.default_rng(0)
    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=620.5,
                            cy_l=188.0, baseline=0.5371).to(dev)
    P, L = 8, 1024
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    prob = BAProblem(poses=f(r.normal(0, 0.01, (P, 6))),
                     lmks=f(np.stack([r.uniform(-5, 5, L), r.uniform(-2, 2, L),
                                      r.uniform(5, 30, L)], -1)),
                     obs=f(r.uniform(0, 400, (P, L, 4))),
                     mask=torch.ones((P, L), dtype=torch.bool, device=dev))
    try:
        bundle_adjust(cam, prob, max_iters=15)
    except _Stop:
        pass
    seq = make_sequence(n_frames=2, n_points=2000, H=376, W=1241)
    base = synthetic_config()
    for backend in ("chol", "eigh"):
        cfg = base.replace(least_squares=dataclasses.replace(
            base.least_squares, solve_backend=backend, use_lm=backend == "eigh"))
        eng = Engine(cfg, seq.cam)
        try:
            eng.process_frame(*seq.frames[0])
        except _Stop:
            pass
    sys.path.insert(0, str(REPO))
    # the batched step, with detect_every 3 (three branches)
    from rso_torch.parallel import BatchEngine

    cfg = base.replace(tpu=dataclasses.replace(base.tpu, detect_every=3))
    be = BatchEngine(cfg, seq.cam, batch=2, img_h=376, img_w=1241)
    lefts = torch.stack([torch.from_numpy(seq.frames[0][0])] * 2).to(dev)
    rights = torch.stack([torch.from_numpy(seq.frames[0][1])] * 2).to(dev)
    try:
        be.process_frames(lefts, rights)
    except _Stop:
        pass
    for site, graphs_, pred in seen:
        for key, segs in graphs_.items():
            _describe(f"{site} {key}", segs)
        if pred is not None:
            _describe(f"{site} predicate", [pred])
    # the bench BA problem as tests/test_torch_cuda.py solves it: the eager
    # loop first, then the compiled solve
    import _torch_card as card

    seen.clear()
    bench = card.bench_ba_problem(cam, dev)
    card.eager_ba(cam, bench, max_iters=25, tol=0.0)
    try:
        bundle_adjust(cam, bench, max_iters=25, tol=0.0)
    except _Stop:
        pass
    for site, graphs_, pred in seen:
        for key, segs in graphs_.items():
            _describe(f"{site} {key} (bench problem, eager first)", segs)
            for seg in segs:
                users = _mem_node_users(seg.graph.raw_cuda_graph())
                if users:
                    print(f"  kernels after its memory allocations: {users}",
                          flush=True)
    # the small solves of the GN's Cholesky branch, one op a graph
    H = torch.eye(6, device=dev) * 4.0
    L = torch.linalg.cholesky(H)
    ops = {"cholesky_ex": lambda: torch.linalg.cholesky_ex(H),
           "cholesky_solve": lambda: torch.cholesky_solve(H, L),
           "solve_triangular": lambda: torch.linalg.solve_triangular(
               L, H, upper=False),
           "cholesky_ex batched": lambda: torch.linalg.cholesky_ex(
               H.expand(3, 6, 6).contiguous())}
    for name, op in ops.items():
        op()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            op()
        _describe(name, [graphs._Segment(g, {}, None)])


def _nccl(child: bool) -> int:
    """The --nccl probe (module docstring); `child`: the run in the
    process with NCCL_GRAPH_MIXING_SUPPORT=0."""
    import collections
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    import rso_torch.graphs as graphs

    label = ("NCCL_GRAPH_MIXING_SUPPORT="
             f"{os.environ.get('NCCL_GRAPH_MIXING_SUPPORT', '(unset)')}")
    print(f"[{label}] torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"nccl {torch.cuda.nccl.version()}", flush=True)
    dev = torch.device("cuda")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    x = torch.zeros(1024, device=dev)
    flag = torch.zeros(1, dtype=torch.bool, device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    for mode in ("thread_local", "global", "relaxed"):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        try:
            with torch.cuda.stream(s):
                g.capture_begin(capture_error_mode=mode)
                try:
                    x.add_(1.0)
                    dist.all_reduce(x)
                    torch.lt(x[:1], 10.0, out=flag)
                finally:
                    g.capture_end()
        except Exception as e:  # noqa: BLE001 - the probe reports any failure
            print(f"[{label}] mode {mode}: capture failed: {e!r}", flush=True)
            continue
        torch.cuda.synchronize()
        _describe(f"[{label}] mode {mode}: x.add_; all_reduce; flag",
                  [graphs._Segment(g, collections.Counter(), None)])
        x.zero_()
        try:
            comp = graphs._Composed(
                {None: [graphs._Segment(g, collections.Counter(),
                                        (flag, 100, "probe"))]},
                None, None, "probe")
            comp.launch()
            torch.cuda.synchronize()
            print(f"[{label}] mode {mode}: composed WHILE ran, x[0] "
                  f"{float(x[0])} (10 expected), blocks "
                  f"{comp.counts.tolist()}", flush=True)
        except Exception as e:  # noqa: BLE001
            print(f"[{label}] mode {mode}: compose/launch failed: {e!r}",
                  flush=True)
    dist.destroy_process_group()
    if not child:
        env = dict(os.environ, NCCL_GRAPH_MIXING_SUPPORT="0")
        out = subprocess.run([sys.executable, __file__, "--nccl", "child"],
                             env=env, capture_output=True, text=True,
                             timeout=300)
        print(out.stdout + out.stderr[-3000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
