"""The traced slice: torch.profiler over a fixed number of steady frames,
reduced to device busy time, time by kernel, and idle gaps by what the
host was doing.

The profiler records device activity only; the harness times its own host
spans (`span`: copying frames in, calling the program, waiting for the
pose) on the clock the profiler's events carry (`time.time_ns`), and a
device gap is put down to the innermost span open on the host when it
began. Tracing every kernel of a graph still slows a live frame 1.6-1.9x,
so the idle share (metrics/device_idle_pct.py) is taken against the
untraced window's time a frame, not the slice's length.
"""
from __future__ import annotations

import collections
import contextlib
import re
import time
from typing import NamedTuple

SHORT_GAP_S = 10e-6     # shorter gaps: between the nodes of a running graph

_SPANS: list | None = None  # (start ns, end ns, name) while a slice is traced


class Trace(NamedTuple):
    busy_s: float               # union of device activity
    window_s: float             # host seconds of the traced slice
    kernel_s: dict              # {kernel base name: seconds}
    kernel_n: dict              # {kernel base name: launches}
    device_ops: list            # [[name, seconds]] the 10 largest
    idle_gaps: list             # [[what the host did, seconds]] the 10 largest


class span:
    """A host span of the harness, kept while a slice is traced (a clock
    read and nothing more outside one)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        if _SPANS is not None:
            _SPANS.append((self.t0, time.time_ns(), self.name))


def base_name(kernel: str) -> str:
    """A kernel's name without its signature, template or namespace."""
    if kernel.startswith(("Memcpy", "Memset")):
        return " ".join(kernel.split()[:2])
    s = kernel.replace("(anonymous namespace)", "anonymous")
    s = re.split(r"[<(]", s)[0].strip()
    return s.split()[-1].split("::")[-1] if s else kernel


@contextlib.contextmanager
def profiled():
    """Profile the device; yields a holder whose `.result` is (the raw
    events, the harness's host spans) once the block has ended."""
    global _SPANS
    from torch.profiler import ProfilerActivity, profile

    class Holder:
        result = None

    h = Holder()
    _SPANS = []
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            yield h
    finally:
        spans, _SPANS = _SPANS, None
    h.result = (p.profiler.kineto_results.events(), spans)


def reduce(events, spans, window_s: float) -> Trace | None:
    """The slice's Trace from the profiler's raw events and the host spans
    (start ns, end ns, name); None where the trace holds no device
    activity."""
    dev = [(e.start_ns(), e.end_ns(), e.name()) for e in events
           if str(e.device_type()).endswith("CUDA")
           and not e.is_user_annotation()]
    dev = [d for d in dev if d[1] > d[0]]
    if not dev:
        return None
    dev.sort()
    kernel_s, kernel_n = collections.Counter(), collections.Counter()
    for s, t, name in dev:
        b = base_name(name)
        kernel_s[b] += (t - s) * 1e-9
        kernel_n[b] += 1
    # union of the device intervals, and the gaps between them
    busy, gaps = 0, []
    cur_s, cur_t = dev[0][0], dev[0][1]
    for s, t, _ in dev[1:]:
        if s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy += cur_t - cur_s
    spans = sorted(spans, key=lambda x: (x[0], -(x[1] - x[0])))
    by_what, open_, i = collections.Counter(), [], 0
    for g0, g1 in gaps:               # both in time order: one sweep
        while i < len(spans) and spans[i][0] <= g0:
            open_.append(spans[i])
            i += 1
        open_ = [x for x in open_ if x[1] > g0]
        what = open_[-1][2] if open_ else "no harness span"  # the innermost
        what += " (short)" if (g1 - g0) * 1e-9 < SHORT_GAP_S else ""
        by_what[what] += (g1 - g0) * 1e-9
    top = lambda c: [[k, v] for k, v in c.most_common(10)]  # noqa: E731
    return Trace(busy_s=busy * 1e-9, window_s=window_s, kernel_s=dict(kernel_s),
                 kernel_n=dict(kernel_n), device_ops=top(kernel_s),
                 idle_gaps=top(by_what))
