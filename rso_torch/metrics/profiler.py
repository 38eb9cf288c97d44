"""The program's spans and its stage clock.

Counterpart of rso/metrics/profiler.py and of MRPT's CTimeLogger as used by
the reference (m_profiler, libstereo-odometry.h:732; spans `_stg1`..`_stg5`,
`processNewImagePair`, etc.).  Summary printing mirrors the on-destruction
report; `device_span` also wraps torch.profiler.record_function, so a
torch.profiler trace carries the same names.

`PROFILER`, one process-wide SpanProfiler, disabled by default, is the
program's own span system.  The engines open its spans at their layer
boundaries: `processNewImagePair` (Engine.process_frame), `process_chunk`
(Engine's and BatchEngine's), `images_in` (the images to the device) and,
in rso_torch.graphs.CompiledStep, `<site>.copy_in` (the caller's state and
inputs into the static buffers), `<site>.launch` (the composed graph's
launch; the eager step on the CPU), `<site>.copy_out` (the state and the
result out) and `<site>.capture` (a signature's warm-up, capture and
composition), site "step" for the engines and "lm" for bundle adjustment.
Disabled, a span costs one attribute check and returns a shared no-op
object.  Recording, each span adds its seconds to `times[name]`, which
`summary` reports.

`STAGE_CLOCK` is the device's side.  With marks on (`STAGE_CLOCK.on`), a
step that rso_torch.graphs.CompiledStep captures carries one-thread mark
kernels at its stage boundaries (csrc/graph_cond.cu, `stage_mark_kernel`;
the names in `STAGES`, marked by rso_torch.engine and robust_gn), and its
static-buffer copies end with an `end` mark.  Each mark charges the
device nanoseconds since the previous mark to the previous mark's stage and
counts one for its own, into a small device table that `settle` reads once
(one copy, one synchronize), as graphs.settle_launches reads the composed
graphs' counters.  Whether marks are on is part of a CompiledStep's variant
key: turning them on captures the step once more, and with them off the
captured graph is the same node for node.  On the CPU (the eager step) a
mark reads `time.time_ns()` into the same table.
"""
from __future__ import annotations

import collections
import time
from contextlib import contextmanager

import numpy as np
import torch

from rso_torch.kernels import _lib


class _NoSpan:
    """The span of a disabled profiler: nothing at all."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("times", "name", "start")

    def __init__(self, times, name: str):
        self.times = times
        self.name = name

    def __enter__(self):
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.times[self.name].append(
            (time.perf_counter_ns() - self.start) * 1e-9)
        return False


class SpanProfiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times = collections.defaultdict(list)   # name -> [seconds]
        self._open: list = []           # enter()'s spans, for leave()

    def span(self, name: str):
        """A host span (a context manager)."""
        if not self.enabled:
            return _NO_SPAN
        return _Span(self.times, name)

    def clear(self) -> None:
        self.times.clear()

    @contextmanager
    def device_span(self, name: str):
        """Span that also annotates the torch.profiler trace."""
        if not self.enabled:
            yield
            return
        with self.span(name):
            with torch.profiler.record_function(name):
                yield

    def enter(self, name: str):
        """MRPT-style explicit enter/leave API."""
        if self.enabled:
            self._open.append(self.span(name).__enter__())

    def leave(self, name: str):
        if self.enabled and self._open:
            s = self._open.pop()
            assert s.name == name, f"unbalanced spans: leave({name}) inside {s.name}"
            s.__exit__(None, None, None)

    def summary(self) -> str:
        lines = [f"{'span':<40}{'calls':>8}{'mean ms':>12}{'total s':>12}"]
        for name in sorted(self.times):
            ts = np.array(self.times[name])
            lines.append(
                f"{name:<40}{len(ts):>8}{1e3 * ts.mean():>12.3f}{ts.sum():>12.3f}")
        return "\n".join(lines)

    def report(self):
        print(self.summary())


# the stage clock's stages, in a step's order: stage 1 (grayscale, remap,
# pyramids), stage 2 (kernel 1, NMS, top-K), detect_every's propagation,
# stage 3 (kernel 2), stage 4 (kernel 3, the gather, the subpixel refine,
# the ID propagation), the RANSAC filter (kernel 4), stage 5 (NMS, the
# solve's set-up, the cut between its phases), one GN block of the WHILE
# node's body, and the error codes, the result and the state shift
STAGES = ("_stg1", "_stg2", "propagate", "_stg3", "_stg4", "ransac", "_stg5",
          "gn_block", "update")
_INDEX = {name: i for i, name in enumerate(STAGES)}
_INDEX["end"] = -1


def _host_mark(a: np.ndarray, stage: int, now: int) -> None:
    """stage_mark_kernel on the CPU twin's table (a numpy view)."""
    n = a.shape[1] - 1
    open_ = a[1, n]
    if open_ > 0:
        a[0, open_ - 1] += now - a[0, n]
    if stage >= 0:
        a[1, stage] += 1
        a[0, n] = now
        a[1, n] = stage + 1
    else:
        a[1, n] = 0


class StageClock:
    """Device nanoseconds and marks by stage (the module docstring)."""

    def __init__(self):
        self.on = False
        self.ns: collections.Counter = collections.Counter()     # settled
        self.marks: collections.Counter = collections.Counter()  # settled
        self._tables: dict = {}     # device -> int64 [2, len(STAGES) + 1]

    def _table(self, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        table = self._tables.get(device)
        if table is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("stage clock: the first mark on a device "
                                   "inside a capture (its table would live "
                                   "in the graph's pool)")
            table = torch.zeros((2, len(STAGES) + 1), dtype=torch.int64,
                                device=device)
            self._tables[device] = table
        return table

    def mark(self, name: str, device) -> None:
        """Mark the start of stage `name` ("end": close the open one) on
        `device`'s stream; nothing while marks are off."""
        if not self.on:
            return
        stage = _INDEX[name]
        table = self._table(device)
        if table.is_cuda:
            rc = _lib.load().rso_stage_mark(
                table.data_ptr(), len(STAGES), stage,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"rso_stage_mark failed: cudaError {rc}")
        else:
            _host_mark(table.numpy(), stage, time.time_ns())

    def settle(self) -> tuple:
        """Add the tables' counts since the last settle or reset to `ns`
        and `marks` (one copy to the host a device, so a synchronize) and
        return (ns, marks); call between frames."""
        n = len(STAGES)
        for table in self._tables.values():
            a = table.cpu().numpy().copy()   # the CPU twin's is a view
            table[:, :n].zero_()
            for i, name in enumerate(STAGES):
                if a[1, i]:
                    self.ns[name] += int(a[0, i])
                    self.marks[name] += int(a[1, i])
        return self.ns, self.marks

    def reset(self) -> None:
        """Zero the tables and the settled counts."""
        for table in self._tables.values():
            table.zero_()
        self.ns.clear()
        self.marks.clear()

    def summary(self, frames: int) -> str:
        """ms a frame by stage over `frames` frames, from the settled
        counts (the device's clock on the GPU, the host's on the CPU)."""
        lines = [f"{'stage':<40}{'marks':>8}{'ms a frame':>12}"
                 f"{'total s':>12}"]
        for name in STAGES:
            if self.marks[name]:
                ns = self.ns[name]
                lines.append(f"{name:<40}{self.marks[name]:>8}"
                             f"{ns * 1e-6 / max(frames, 1):>12.3f}"
                             f"{ns * 1e-9:>12.3f}")
        total = sum(self.ns.values())
        lines.append(f"{'all stages':<40}{'':>8}"
                     f"{total * 1e-6 / max(frames, 1):>12.3f}"
                     f"{total * 1e-9:>12.3f}")
        return "\n".join(lines)


PROFILER = SpanProfiler(enabled=False)
STAGE_CLOCK = StageClock()
