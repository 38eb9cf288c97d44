"""The compiled per-frame step: the engine's counterpart of rso's jax.jit.

rso jit-compiles its step once per (h, w, precomputed) and runs each frame
as one device program, its loops (lax.while_loop) and its detect_every
branch (lax.cond) included.  Here `CompiledStep` holds, per signature of the
state and the inputs (shapes, dtypes, devices), static buffers for the
state, the inputs and the result and, on the GPU, ONE CUDA graph launched
once a frame, with no host read inside it.  It is composed
(csrc/graph_cond.cu) from segments captured as PyTorch CUDA graphs, split
where the pose solver's loops are:

    pre     everything up to the first GN block of phase 1
    block   one block of GN_BLOCK masked GN iterations of phase 1, the body
            of a conditional WHILE node that runs it again while the flag
            the block computed on the device is true (lax.while_loop), and
            at most as many times as the eager loop would
    mid     the outlier cut between the phases
    block   the same for phase 2
    tail    the rest of the step, ending with copies of the new state and
            the result into the static buffers

A block's carry is cloned at the end of the segment before it, and each
block writes its output back into that clone, so a block run again reads
what the last run wrote.  With detect_every > 1 (`Branches`) every branch
of the step (detect and propagate; for a batched step also `mixed`) has its
segments, each the body of a conditional IF node, and a predicate graph
computes on the device which one runs (lax.cond).

The first frame of each signature runs the step eagerly on a side stream,
the warm-up PyTorch's graph rules ask for (it builds the kernels,
initialises cuBLAS and fills the cached tables), and that run is the
frame's answer; each branch that frame did not take is warmed too, on the
same static buffers, and its outputs thrown away (as torch.cond's capture
warms both sides).  Then every branch is captured, recorded and not run,
and the graph composed.  A host read or a copy from pageable memory inside
the step makes the capture raise; nothing falls back to eager, and a
missing conditional-node API raises.

The caller's state is copied into the static buffers before each frame and
the new state and the result are copied out after it, so a later step never
changes a state or a result the caller holds.  With `capture=False` (the
CPU) the same object runs the step eagerly through the same buffers: the
host reads the branch before the frame and the loops' flags once a block
(`in_place_blocks`), each GN block writing its carry in place as a graph's
block does.

A launch runs no Python wrapper: each segment's kernel launches are
recorded at capture (rso_torch.kernels._lib.record_begin).  Those outside the
conditional nodes are added to LAUNCHES at each launch; the composed graph
counts on the device the blocks each loop ran and the times each branch was
taken, and `settle_launches` adds their launches to LAUNCHES (a read of the
device counters: call it before reading LAUNCHES after a composed graph
ran; `reset_launches` zeroes both).  GRAPH_LAUNCHES counts the composed
graphs' launches by site.

The step may be a torch.func.vmap of the engine's step over a leading
lanes' axis (rso_torch.parallel.BatchEngine: rso's jax.vmap).  Its static
buffers then hold every lane, the kernels launch once for all of them
(their vmap rules), and the block's flag is `any_lane`'s: one flag for all
lanes, with no lanes' axis.  The carry's leaves are vmap's wrappers, which
die when the step returns, so nothing but that flag is kept of them; the
carry's copies inside the step are per-leaf `copy_` (vmap has no rule for
the batched `_foreach_copy_`).

Bundle adjustment's LM solve (rso_torch.ba.ba.solve_lm) is a CompiledStep
too, of a function without state (state None): pre (the carry and the
first cost), one block of LM_BLOCK masked LM iterations in a WHILE node,
and tail (the result).  Its carry names its own flag and HOST_READS site
(`stop_flag`), as GNCarry does.  On a mesh (an NCCL group) the solve's
all_reduces are captured with the rest, inside the WHILE node's body: the
counterpart of rso's jax.jit(shard_map(lax.while_loop + lax.psum)).
COLLECTIVES counts them as LAUNCHES counts kernels: recorded at capture,
added at each launch, and those inside the WHILE node by settle_launches.
A conditional body takes kernel, memcpy, memset, child-graph, empty and
conditional nodes only (`_BODY_TYPES`).  Where a loop's captured block
holds any other node type (NCCL's all_reduce across ranks), the variant
runs in the block form instead: each segment its own graph launch, the
block launched again while its flag, read on the host once a block, says
so.  The rule reads the captured graph's node types; it is no fallback
from a failure, and a composition or instantiation that fails raises with
the segments' node types.

Both of the program's tracers (rso_torch.metrics.profiler) reach in here,
and both are off by default.  PROFILER's host spans `<site>.copy_in`,
`<site>.launch`, `<site>.copy_out` and `<site>.capture` time a step's
copies into the static buffers, its launch (the eager step on the CPU),
its copies out, and a signature's warm-up, capture and composition.
STAGE_CLOCK's marks are kernels of the step itself: a variant captured
while they are on (`STAGE_CLOCK.on` is part of the variant key) carries
the marks the step's stages make and an `end` mark after its copies into
the static buffers, and with them off the captured graph is the same node
for node.  Marks do not count in LAUNCHES.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import gc
import weakref
from typing import Callable, NamedTuple

import torch

from rso_torch.kernels import _lib
from rso_torch.kernels._lib import LAUNCHES
from rso_torch.metrics.profiler import PROFILER, STAGE_CLOCK
from rso_torch.solver.robust_gn import read_flag, stops_after

# launches of composed graphs, by CompiledStep site ("step", "lm")
GRAPH_LAUNCHES: collections.Counter = collections.Counter()
# the composed graphs alive, whose device counters settle_launches reads
_COMPOSED = weakref.WeakSet()


def settle_launches() -> collections.Counter:
    """Add to LAUNCHES (and to COLLECTIVES) the launches (all_reduces) the
    composed graphs counted on the device (inside their WHILE and IF nodes)
    since the last settle or reset, and return LAUNCHES: one copy to the
    host, and so a synchronize, a composed graph."""
    for c in list(_COMPOSED):
        _lib.tally(c.settle())
    return LAUNCHES


def reset_launches() -> None:
    """Zero LAUNCHES, COLLECTIVES, the composed graphs' device counters and
    their branches' tallies (`CompiledStep.taken`)."""
    for c in list(_COMPOSED):
        c.discard()
    LAUNCHES.clear()
    _lib.COLLECTIVES.clear()


def tree_map(fn, *trees):
    """Map fn over the tensor leaves of matching NamedTuple/tuple trees
    (None leaves stay None)."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    mapped = [tree_map(fn, *xs) for xs in zip(*trees)]
    return type(t0)(*mapped) if hasattr(t0, "_fields") else tuple(mapped)


def leaves(tree) -> list:
    """The tensor leaves of a NamedTuple/tuple tree, in order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for sub in tree for x in leaves(sub)]


def _copy(dst: list, src: list) -> None:
    if dst:
        torch._foreach_copy_(dst, src)


def _copy_leaves(dst, src) -> None:
    """Copy tree src into tree dst leaf by leaf (inside a step, where the
    leaves may be vmap's wrappers)."""
    for d, t in zip(leaves(dst), leaves(src)):
        d.copy_(t)


def tree_clone(tree):
    """Fresh tensors with the tree's values (one batched copy)."""
    out = tree_map(torch.empty_like, tree)
    _copy(leaves(out), leaves(tree))
    return out


def _carry_clone(tree):
    """tree_clone inside a step (vmap's wrappers allowed)."""
    return tree_map(torch.clone, tree)


def _signature(tree) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves(tree))


def _check_disjoint(dst: list, src: list) -> None:
    """src[i] may be dst[i] itself (or a view of exactly its memory, as
    vmap returns it), but no other source may share memory with a
    destination: the batched copy would read what it overwrote."""
    def span(t):
        if t.numel() == 0:
            return None
        lo = t.data_ptr()
        last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
        return lo, lo + t.element_size() * (last + 1)

    spans = [span(d) for d in dst]
    for j, s in enumerate(src):
        b = span(s)
        for i, a in enumerate(spans):
            if (a and b and i != j and s is not dst[i] and b != spans[j]
                    and a[0] < b[1] and b[0] < a[1]):
                raise RuntimeError("compiled step: an output shares memory "
                                   "with another static buffer")


def in_place_blocks(block, carry, n_blocks: int):
    """The GN loop runner of the eager form: the carry is cloned once and
    each block writes its output back into the clone, as a replay does."""
    if n_blocks == 0:
        return carry
    carry = _carry_clone(carry)
    for b in range(n_blocks):
        _copy_leaves(carry, block(carry))
        if stops_after(carry, b, n_blocks):
            break
    return carry


class Branches(NamedTuple):
    """The branches of a step (detect_every's lax.cond): `keys`, the values
    the step takes as `do_detect`; `read(state) -> key`, the branch read
    back to the host (the eager form's one read a frame); `flags(state) ->
    [len(keys)] bool`, the same choice on the device, one-hot, for the
    composed graph's IF nodes."""

    keys: tuple
    read: Callable
    flags: Callable


class _Segment(NamedTuple):
    graph: torch.cuda.CUDAGraph     # captured with keep_graph=True
    launches: collections.Counter   # kernel launches (all_reduces) of a run
    loop: tuple | None              # (flag, n_blocks, HOST_READS site) for
    #                                 a loop's block


class _Capture:
    """The loop runner while a step is captured: it closes the open graph,
    captures one block as a graph of its own on the cloned carry, and opens
    the next graph.  Each graph's launches are recorded, not counted."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.segments: list[_Segment] = []
        self._graph = None
        self._launches = None

    def begin(self) -> None:
        graph = _graph()
        self._launches = _lib.record_begin()
        self._graph = graph
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def end(self, loop=None) -> None:
        graph, self._graph = self._graph, None
        try:
            graph.capture_end()
        finally:
            _lib.record_end(self._launches)
        self.segments.append(_Segment(graph, self._launches, loop))

    def abandon(self) -> None:
        """End a capture that failed, so that the stream leaves capture
        mode; the caller re-raises the failure."""
        if self._graph is not None:
            with contextlib.suppress(RuntimeError):
                self._graph.capture_end()
            _lib.record_end(self._launches)
            self._graph = None

    def __call__(self, block, carry, n_blocks: int):
        if n_blocks == 0:
            return carry
        carry = _carry_clone(carry)
        self.end()
        self.begin()
        _copy_leaves(carry, block(carry))
        site, flag = carry.stop_flag()
        self.end(loop=(flag, n_blocks, site))
        self.begin()
        return carry


@contextlib.contextmanager
def _no_gc():
    """The cyclic garbage collector off inside the block."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _graph() -> torch.cuda.CUDAGraph:
    """A CUDA graph whose cudaGraph_t outlives its capture (keep_graph), to
    be composed; raises where this PyTorch cannot keep it."""
    try:
        return torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError as e:
        raise RuntimeError(
            "compiled step: this PyTorch cannot keep a captured graph "
            "(CUDAGraph(keep_graph=True))") from e


# the node types a conditional node's body takes (cudaGraphNodeType: kernel,
# memcpy, memset, child graph, empty, conditional)
_BODY_TYPES = frozenset({0, 1, 2, 4, 5, 13})


def node_types(graph: int) -> dict:
    """cudaGraphNodeType -> count of the nodes of cudaGraph_t `graph`, its
    child graphs' included."""
    counts = (ctypes.c_int * 16)()
    _lib.call("graph_node_types", graph, counts, 16)
    return {t: n for t, n in enumerate(counts) if n}


class _Composer:
    """One graph built from captured segments through csrc/graph_cond.cu."""

    def __init__(self, counts: torch.Tensor, iters: torch.Tensor):
        self.counts, self.iters = counts, iters
        self.slots: list[collections.Counter] = []   # launches a count
        self.n_loops = 0
        self.graph = self._out("graph_create")

    @staticmethod
    def _out(name, *args):
        out = ctypes.c_void_p()
        _lib.call(name, *args, ctypes.byref(out))
        return out.value

    def _handle(self, graph) -> int:
        h = ctypes.c_ulonglong()
        _lib.call("graph_add_handle", graph, ctypes.byref(h))
        return h.value

    def _set(self, graph, dep, handle, flag=None, slot=None, loop=None,
             limit=0):
        count = (None if slot is None
                 else self.counts.data_ptr() + 8 * slot)
        it = None if loop is None else self.iters.data_ptr() + 4 * loop
        return self._out("graph_add_set", graph, dep, handle, flag, count, it,
                         limit)

    def _cond(self, graph, dep, handle, is_while: bool):
        node, body = ctypes.c_void_p(), ctypes.c_void_p()
        _lib.call("graph_add_cond", graph, dep, handle, int(is_while),
                  ctypes.byref(node), ctypes.byref(body))
        return node.value, body.value

    def _slot(self, launches) -> int:
        self.slots.append(launches)
        return len(self.slots) - 1

    def _child(self, graph, dep, segment: _Segment):
        raw = segment.graph.raw_cuda_graph()
        try:
            return self._out("graph_add_child", graph, dep, raw)
        except RuntimeError as e:
            raise RuntimeError(f"{e}: a captured segment with nodes of types "
                               f"{node_types(raw)} (cudaGraphNodeType; 10 "
                               "and 11, memory nodes, cannot be composed)"
                               ) from None

    def segments(self, graph, dep, segments, fixed: collections.Counter):
        """Add segments to `graph` after `dep`: each a child node, each
        loop's block the body of a WHILE node (its launches a slot of the
        block counts); the others' launches go to `fixed`.  Returns the
        last node."""
        for seg in segments:
            if seg.loop is None:
                dep = self._child(graph, dep, seg)
                fixed.update(seg.launches)
                continue
            flag, n_blocks, _ = seg.loop
            slot, loop = self._slot(seg.launches), self.n_loops
            self.n_loops += 1
            h = self._handle(graph)
            # the first block always runs, as in the eager loop
            dep = self._set(graph, dep, h, slot=slot, loop=loop)
            dep, body = self._cond(graph, dep, h, is_while=True)
            node = self._child(body, None, seg)
            self._set(body, node, h, flag.data_ptr(), slot, loop, n_blocks)
        return dep

    def branches(self, pred: _Segment, flags: torch.Tensor, per_key: list,
                 fixed: collections.Counter) -> list:
        """The predicate graph, then one IF node a branch (a branch's
        launches outside its loops a slot of its IF's counts).  Returns
        the branches' slots."""
        dep = self._child(self.graph, None, pred)
        fixed.update(pred.launches)
        handles = []
        for i, segments in enumerate(per_key):
            h = self._handle(self.graph)
            branch_fixed = collections.Counter()
            slot = self._slot(branch_fixed)
            handles.append((h, segments, branch_fixed, slot))
            dep = self._set(self.graph, dep, h, flags.data_ptr() + i, slot)
        for h, segments, branch_fixed, _ in handles:
            dep, body = self._cond(self.graph, dep, h, is_while=False)
            self.segments(body, None, segments, branch_fixed)
        return [slot for *_, slot in handles]


def _destroy(graph, exec_):
    _lib.call("graph_exec_destroy", exec_)
    _lib.call("graph_destroy", graph)


class _Composed:
    """A variant's one CUDA graph: every branch's segments, the loops as
    WHILE nodes and the branches as IF nodes, launched once a frame."""

    def __init__(self, graphs: dict, pred, flags, site: str):
        n_loops = sum(seg.loop is not None for segs in graphs.values()
                      for seg in segs)
        n_slots = n_loops + (len(graphs) if pred is not None else 0)
        dev = torch.device("cuda", torch.cuda.current_device())
        # device counters: blocks a loop ran, times a branch was taken
        self.counts = torch.zeros(max(n_slots, 1), dtype=torch.int64,
                                  device=dev)
        self.iters = torch.zeros(max(n_loops, 1), dtype=torch.int32,
                                 device=dev)
        b = _Composer(self.counts, self.iters)
        self.fixed = collections.Counter()     # launches of every launch
        self._branch_slots = {}
        if pred is None:
            b.segments(b.graph, None, graphs[None], self.fixed)
        else:
            self._branch_slots = dict(zip(graphs, b.branches(
                pred, flags, list(graphs.values()), self.fixed)))
        self.slots = b.slots
        # the captured graphs own the memory the nodes address
        self._owned = (graphs, pred, flags)
        exec_ = ctypes.c_void_p()
        try:
            _lib.call("graph_instantiate", b.graph, ctypes.byref(exec_))
        except RuntimeError as e:
            _lib.call("graph_destroy", b.graph)
            types = [node_types(seg.graph.raw_cuda_graph())
                     for segs in graphs.values() for seg in segs]
            raise RuntimeError(f"{e}: segments with nodes of types {types} "
                               "(cudaGraphNodeType)") from None
        self.exec = exec_.value
        self.site = site
        # destroyed with the object; at exit the process's teardown frees it
        self._finalizer = weakref.finalize(self, _destroy, b.graph, self.exec)
        self._finalizer.atexit = False
        self._taken = collections.Counter()
        _COMPOSED.add(self)

    def launch(self) -> None:
        _lib.call("graph_launch", self.exec,
                  torch.cuda.current_stream().cuda_stream)
        _lib.tally(self.fixed)
        GRAPH_LAUNCHES[self.site] += 1

    def settle(self) -> collections.Counter:
        """The launches counted on the device since the last settle (one
        read of the counters); zeroes them."""
        counts = self.counts.tolist()
        self.counts.zero_()
        out = collections.Counter()
        for n, launches in zip(counts, self.slots):
            for k, v in launches.items():
                if n * v:
                    out[k] += n * v
        for key, slot in self._branch_slots.items():
            self._taken[key] += counts[slot]
        return out

    def discard(self) -> None:
        self.counts.zero_()
        self._taken.clear()

    def taken(self) -> dict:
        """Frames each branch ran since the last reset_launches()."""
        _lib.tally(self.settle())
        return dict(self._taken)


class _Blocks:
    """A variant whose loop's block holds nodes that no conditional body
    takes (NCCL's all_reduce across ranks; `_BODY_TYPES`): each segment is
    a graph launch of its own and a loop's block is launched again while
    its flag, read on the host once a block, says so (the block form)."""

    def __init__(self, graphs: dict, site: str):
        if list(graphs) != [None]:
            raise RuntimeError("compiled step: a step with branches whose "
                               "loop no conditional body takes")
        self.segments = graphs[None]
        for seg in self.segments:
            seg.graph.instantiate()
        self.site = site

    def launch(self) -> None:
        for seg in self.segments:
            n_blocks = 1 if seg.loop is None else seg.loop[1]
            for b in range(n_blocks):
                seg.graph.replay()
                _lib.tally(seg.launches)
                GRAPH_LAUNCHES[self.site] += 1
                if seg.loop is not None and (b + 1 == n_blocks or not
                                             read_flag(seg.loop[2],
                                                       seg.loop[0])):
                    break

    def taken(self) -> dict:
        return {}


class _Variant:
    """Static buffers for one signature of the state and the inputs, the
    captured graph segments of each branch and the composed graph."""

    def __init__(self, state, inputs):
        self.state = tree_map(torch.empty_like, state)
        self.inputs = tree_map(torch.empty_like, inputs)
        self.result = None
        self.graphs: dict = {}
        self.pred = None            # (segment, flags) with branches
        self.composed: _Composed | None = None
        self.checked: set = set()   # (branch, eager?) whose outputs were checked


class CompiledStep:
    """step(state, *inputs) -> (state', result) through static buffers and,
    with `capture`, one composed CUDA graph a signature (the module
    docstring).  `state` may be None, for a function without state.

    fn(state, *inputs, loop=runner[, do_detect=branch]) is the eager step;
    `branches` (Branches), where given, are the step's branches, passed to
    fn as `do_detect`.  `site` names the step in GRAPH_LAUNCHES."""

    def __init__(self, fn, branches: Branches | None = None,
                 capture: bool = True, site: str = "step"):
        self.fn = fn
        self.branches = branches
        self.capture = capture
        self.site = site
        self._variants: dict = {}
        self._stream = None
        # PROFILER's span names of this step
        self._copy_in, self._launch, self._copy_out, self._capture_span = (
            f"{site}.{s}" for s in ("copy_in", "launch", "copy_out",
                                    "capture"))

    @property
    def n_graphs(self) -> int:
        """CUDA graphs captured so far (segments and predicates), over every
        signature and branch."""
        return sum(len(segs) for v in self._variants.values()
                   for segs in v.graphs.values()) + sum(
            v.pred is not None for v in self._variants.values())

    @property
    def n_composed(self) -> int:
        """Composed graphs (one a signature), each launched once a step."""
        return sum(v.composed is not None for v in self._variants.values())

    def taken(self) -> dict:
        """Frames each branch ran in the composed graphs since the last
        reset_launches() (one read of the device counters)."""
        out = collections.Counter()
        for v in self._variants.values():
            if v.composed is not None:
                out.update(v.composed.taken())
        return dict(out)

    def _variant(self, state, inputs) -> _Variant:
        key = (_signature(state), _signature(inputs), STAGE_CLOCK.on)
        v = self._variants.get(key)
        if v is None:
            v = self._variants[key] = _Variant(state, inputs)
        return v

    def _call_fn(self, v: _Variant, loop, branch):
        kw = {} if self.branches is None else {"do_detect": branch}
        new_state, result = self.fn(v.state, *v.inputs, loop=loop, **kw)
        if v.result is None:
            v.result = tree_map(torch.empty_like, result)
        dst = leaves(v.state) + leaves(v.result)
        src = leaves(new_state) + leaves(result)
        if (branch, loop is in_place_blocks) not in v.checked:
            _check_disjoint(dst, src)
            v.checked.add((branch, loop is in_place_blocks))
        _copy(dst, src)
        STAGE_CLOCK.mark("end", dst[0].device)

    def _run(self, v: _Variant) -> None:
        """One frame from v.state and v.inputs; leaves the new state in
        v.state and the result in v.result."""
        if v.composed is not None:
            with PROFILER.span(self._launch):
                v.composed.launch()
        elif not self.capture:
            with PROFILER.span(self._launch):
                self._call_fn(v, in_place_blocks, self._branch(v))
        else:
            with PROFILER.span(self._capture_span):
                self._warm_up(v)
                self._capture(v)

    def _branch(self, v: _Variant):
        return None if self.branches is None else self.branches.read(v.state)

    def _warm_up(self, v: _Variant) -> None:
        """The warm-up on a side stream, which is this frame's answer; the
        branches it did not take are warmed from the same state, then the
        answer is put back."""
        branch = self._branch(v)
        with torch.cuda.stream(self._side_stream()):
            before = tree_clone(v.state)
            self._call_fn(v, in_place_blocks, branch)
            if self.branches is not None:
                answer = tree_clone(v.state), tree_clone(v.result)
                for key in self.branches.keys:
                    if key != branch:
                        _copy(leaves(v.state), leaves(before))
                        self._call_fn(v, in_place_blocks, key)
                _copy(leaves(v.state) + leaves(v.result),
                      leaves(answer[0]) + leaves(answer[1]))
        torch.cuda.synchronize()

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        self._stream.wait_stream(torch.cuda.current_stream())
        return self._stream

    def _capture(self, v: _Variant) -> None:
        """Capture every branch of v (recorded, not run) and compose v's
        graph.  The garbage collector waits until the capture ends: a dead
        step's graphs freed inside a capture would call CUDA's graph
        destroy there, which invalidates the capture."""
        keys = (None,) if self.branches is None else self.branches.keys
        with torch.cuda.stream(self._side_stream()), _no_gc():
            for key in keys:
                cap = _Capture()
                cap.begin()
                try:
                    self._call_fn(v, cap, key)
                    cap.end()
                except BaseException:
                    cap.abandon()
                    raise
                v.graphs[key] = cap.segments
            if self.branches is not None:
                cap = _Capture()
                cap.begin()
                try:
                    flags = self.branches.flags(v.state)
                    cap.end()
                except BaseException:
                    cap.abandon()
                    raise
                v.pred = (cap.segments[0], flags)
        torch.cuda.synchronize()
        blocks = [seg for segs in v.graphs.values() for seg in segs
                  if seg.loop is not None]
        if any(set(node_types(seg.graph.raw_cuda_graph())) - _BODY_TYPES
               for seg in blocks):
            v.composed = _Blocks(v.graphs, self.site)
            return
        pred, flags = v.pred if v.pred is not None else (None, None)
        v.composed = _Composed(v.graphs, pred, flags, self.site)

    def __call__(self, state, *inputs):
        v = self._variant(state, inputs)
        with PROFILER.span(self._copy_in):
            _copy(leaves(v.state) + leaves(v.inputs),
                  leaves(state) + leaves(inputs))
        self._run(v)
        with PROFILER.span(self._copy_out):
            return tree_clone(v.state), tree_clone(v.result)

    def chunk(self, state, *input_seqs):
        """N frames (input_seqs: one sequence of N per input) from `state`:
        (the state after the last frame, the results stacked along a
        leading frame axis).  The state stays in the static buffers from
        one frame to the next, and nothing is read back between frames."""
        n = len(input_seqs[0])
        v, stacked = None, None
        for i in range(n):
            inputs = tuple(seq[i] for seq in input_seqs)
            with PROFILER.span(self._copy_in):
                if v is None:
                    v = self._variant(state, inputs)
                    _copy(leaves(v.state), leaves(state))
                else:
                    prev, v = v, self._variant(v.state, inputs)
                    if v is not prev:
                        _copy(leaves(v.state), leaves(prev.state))
                _copy(leaves(v.inputs), leaves(inputs))
            self._run(v)
            with PROFILER.span(self._copy_out):
                if stacked is None:
                    stacked = tree_map(lambda t: t.new_empty((n,) + t.shape),
                                       v.result)
                _copy([t[i] for t in leaves(stacked)], leaves(v.result))
                if i + 1 == n:
                    state = tree_clone(v.state)
        return state, stacked
