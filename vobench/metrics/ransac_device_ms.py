"""Device milliseconds a frame of the fundamental-matrix RANSAC filter: the
traced seconds of the `ransac_kernel` launches over the slice's frames (all
lanes; one launch a SAD frame or batched step, one an octave on the flow
path). None where the trace shows no such kernel (a program whose RANSAC is
not that kernel)."""

KERNEL = "ransac_kernel"


def read(rec, cell):
    t = rec.trace
    if t is None or not rec.trace_frames or not t.kernel_s.get(KERNEL):
        return None
    return 1e3 * t.kernel_s[KERNEL] / rec.trace_frames
