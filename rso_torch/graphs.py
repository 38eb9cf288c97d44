"""The compiled per-frame step: the engine's counterpart of rso's jax.jit.

rso jit-compiles its step once per (h, w, precomputed) and runs each frame
as one device program.  Here `CompiledStep` holds, per signature of the
state and the inputs (shapes, dtypes, devices), static buffers for the
state, the inputs and the result, and per branch of the step (detect or
propagate with detect_every > 1: the counterpart of the reference's
lax.cond) a set of CUDA graphs captured once and replayed on every frame.
The graphs are split where the pose solver reads its stop flag:

    pre     everything up to the first GN block of phase 1
    block   one block of GN_BLOCK masked GN iterations of phase 1, replayed
            until its stop flag, read after each replay but the last, is
            false (the counterpart of lax.while_loop)
    mid     the outlier cut between the phases
    block   the same for phase 2
    tail    the rest of the step, ending with copies of the new state and
            the result into the static buffers

A block's carry is cloned at the end of the segment before it, and each
block writes its output back into that clone, so a replayed block reads what
the last replay wrote; the block's graph also computes the carry's stop
flag into a buffer of its own, which the host reads between replays.  The
first frame of each (signature, branch) runs the step eagerly on a side
stream, the warm-up PyTorch's graph rules ask for (it builds the kernels,
initialises cuBLAS and cuSOLVER and fills the cached tables), and that run
is the frame's answer; the capture then records the step without running
it.  A host read or a copy from pageable memory inside
the step makes the capture raise; nothing falls back to eager.

The caller's state is copied into the static buffers before each frame and
the new state and the result are copied out after it, so a later step never
changes a state or a result the caller holds.  With `capture=False` (the
CPU, and the solve backends that cannot be captured) the same object runs
the step eagerly through the same buffers, each GN block writing its carry
in place as a replay does.

A replay runs no Python wrapper: each segment's kernel launches are
recorded at capture (and taken back out of LAUNCHES, since a capture
launches nothing) and added to LAUNCHES on every replay.

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
first cost), one block of LM_BLOCK masked LM iterations replayed until its
stop flag is false, and tail (the result).  Its carry names its own flag
and HOST_READS site (`stop_flag`), as GNCarry does.
"""
from __future__ import annotations

import collections
import contextlib
from typing import NamedTuple

import torch

from rso_torch.kernels._lib import LAUNCHES
from rso_torch.solver.robust_gn import read_flag, stops_after


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


class _Segment(NamedTuple):
    graph: torch.cuda.CUDAGraph
    launches: collections.Counter   # kernel launches of one replay
    loop: tuple | None              # (site, flag, n_blocks) for a GN block


class _Capture:
    """The GN loop runner while a step is captured: it closes the open
    graph, captures one block as a graph of its own on the cloned carry,
    and opens the next graph."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.segments: list[_Segment] = []
        self._graph = None
        self._saved = None

    def begin(self) -> None:
        self._saved = collections.Counter(LAUNCHES)
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode="thread_local")

    def end(self, loop=None) -> None:
        graph, self._graph = self._graph, None
        graph.capture_end()
        self.segments.append(_Segment(graph, LAUNCHES - self._saved, loop))
        LAUNCHES.clear()
        LAUNCHES.update(self._saved)

    def abandon(self) -> None:
        """End a capture that failed, so that the stream leaves capture
        mode; the caller re-raises the failure."""
        if self._graph is not None:
            with contextlib.suppress(RuntimeError):
                self._graph.capture_end()
            LAUNCHES.clear()
            LAUNCHES.update(self._saved)

    def __call__(self, block, carry, n_blocks: int):
        if n_blocks == 0:
            return carry
        carry = _carry_clone(carry)
        self.end()
        self.begin()
        _copy_leaves(carry, block(carry))
        site, flag = carry.stop_flag()
        self.end(loop=(site, flag, n_blocks))
        self.begin()
        return carry


def _replay(segments) -> None:
    for seg in segments:
        n_blocks = 1 if seg.loop is None else seg.loop[2]
        for b in range(n_blocks):
            seg.graph.replay()
            LAUNCHES.update(seg.launches)
            if b + 1 == n_blocks or not read_flag(*seg.loop[:2]):
                break


class _Variant:
    """Static buffers for one signature of the state and the inputs, and
    the captured graph segments of each branch."""

    def __init__(self, state, inputs):
        self.state = tree_map(torch.empty_like, state)
        self.inputs = tree_map(torch.empty_like, inputs)
        self.result = None
        self.graphs: dict = {}
        self.checked: set = set()   # (branch, eager?) whose outputs were checked


class CompiledStep:
    """step(state, *inputs) -> (state', result) through static buffers and,
    with `capture`, CUDA graphs (the module docstring).  `state` may be
    None, for a function without state.

    fn(state, *inputs, loop=runner[, do_detect=branch]) is the eager step;
    `branch(state) -> bool`, where given, picks the step's branch before
    each frame (one host read) and is passed to fn as `do_detect`."""

    def __init__(self, fn, branch=None, capture: bool = True):
        self.fn = fn
        self.branch = branch
        self.capture = capture
        self._variants: dict = {}
        self._stream = None

    @property
    def n_graphs(self) -> int:
        """CUDA graphs captured so far, over every signature and branch."""
        return sum(len(segs) for v in self._variants.values()
                   for segs in v.graphs.values())

    def _variant(self, state, inputs) -> _Variant:
        key = (_signature(state), _signature(inputs))
        v = self._variants.get(key)
        if v is None:
            v = self._variants[key] = _Variant(state, inputs)
        return v

    def _call_fn(self, v: _Variant, loop, branch):
        kw = {} if self.branch is None else {"do_detect": branch}
        new_state, result = self.fn(v.state, *v.inputs, loop=loop, **kw)
        if v.result is None:
            v.result = tree_map(torch.empty_like, result)
        dst = leaves(v.state) + leaves(v.result)
        src = leaves(new_state) + leaves(result)
        if (branch, loop is in_place_blocks) not in v.checked:
            _check_disjoint(dst, src)
            v.checked.add((branch, loop is in_place_blocks))
        _copy(dst, src)

    def _run(self, v: _Variant) -> None:
        """One frame from v.state and v.inputs; leaves the new state in
        v.state and the result in v.result."""
        branch = None if self.branch is None else self.branch(v.state)
        if not self.capture:
            self._call_fn(v, in_place_blocks, branch)
            return
        segments = v.graphs.get(branch)
        if segments is not None:
            _replay(segments)
            return
        # the warm-up on a side stream is this frame's answer
        with torch.cuda.stream(self._side_stream()):
            self._call_fn(v, in_place_blocks, branch)
        torch.cuda.synchronize()
        self._capture(v, branch)

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        self._stream.wait_stream(torch.cuda.current_stream())
        return self._stream

    def _capture(self, v: _Variant, branch) -> None:
        """Capture v's graph segments of `branch` (recorded, not run)."""
        cap = _Capture()
        with torch.cuda.stream(self._side_stream()):
            cap.begin()
            try:
                self._call_fn(v, cap, branch)
                cap.end()
            except BaseException:
                cap.abandon()
                raise
        torch.cuda.synchronize()
        v.graphs[branch] = cap.segments

    def __call__(self, state, *inputs):
        v = self._variant(state, inputs)
        _copy(leaves(v.state) + leaves(v.inputs),
              leaves(state) + leaves(inputs))
        self._run(v)
        return tree_clone(v.state), tree_clone(v.result)

    def chunk(self, state, *input_seqs):
        """N frames (input_seqs: one sequence of N per input) from `state`:
        (the state after the last frame, the results stacked along a
        leading frame axis).  The state stays in the static buffers from
        one frame to the next."""
        n = len(input_seqs[0])
        v, stacked = None, None
        for i in range(n):
            inputs = tuple(seq[i] for seq in input_seqs)
            if v is None:
                v = self._variant(state, inputs)
                _copy(leaves(v.state), leaves(state))
            else:
                prev, v = v, self._variant(v.state, inputs)
                if v is not prev:
                    _copy(leaves(v.state), leaves(prev.state))
            _copy(leaves(v.inputs), leaves(inputs))
            self._run(v)
            if stacked is None:
                stacked = tree_map(lambda t: t.new_empty((n,) + t.shape),
                                   v.result)
            _copy([t[i] for t in leaves(stacked)], leaves(v.result))
        return tree_clone(v.state), stacked
