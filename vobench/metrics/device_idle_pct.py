"""Share of the window in which nothing ran on the device: 100 x (1 -
device busy time a frame in the traced slice / the untraced window's time
a frame). The traced slice's own length is not the denominator: tracing
every kernel of a graph slows a live frame's launch by 1.6-1.9x, and the
share would follow the tracer."""


def read(rec, cell):
    t = rec.trace
    if t is None or not rec.trace_frames or not rec.window_frames:
        return None
    busy = t.busy_s / rec.trace_frames
    return 100.0 * (1.0 - busy / (rec.window_s / rec.window_frames))
