"""The LK kernel's share of its roofline in the traced slice: LK's least
time a frame (roofline_lk.py, counted from the mathematics at the
configuration's shapes) times the slice's frames, over the traced seconds
of the `lk_track_kernel` launches. None where the trace shows no such
kernel."""
from vobench import roofline, roofline_lk
from vobench.metrics.lk_device_ms import KERNEL


def read(rec, cell):
    t = rec.trace
    if t is None or not rec.trace_frames or not t.kernel_s.get(KERNEL):
        return None
    least = roofline_lk.frame_least_s(cell["cfg"], roofline.ini_shapes(cell["ini"]))
    return 100.0 * least * rec.trace_frames / t.kernel_s[KERNEL]
