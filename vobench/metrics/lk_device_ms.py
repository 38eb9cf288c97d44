"""Device milliseconds a frame of stage 4's pyramidal LK: the traced
seconds of the `lk_track_kernel` launches over the slice's frames (all
lanes). None where the trace shows no such kernel (a program whose LK is
not that kernel)."""

KERNEL = "lk_track_kernel"


def read(rec, cell):
    t = rec.trace
    if t is None or not rec.trace_frames or not t.kernel_s.get(KERNEL):
        return None
    return 1e3 * t.kernel_s[KERNEL] / rec.trace_frames
