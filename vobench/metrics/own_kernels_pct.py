"""Share of the device's busy time in the traced slice spent in the
program's own kernels (rso_torch/csrc: kernels 1-6, eigh6), found by their
trace names."""
from vobench.roofline import OWN_KERNELS


def read(rec, cell):
    t = rec.trace
    if t is None or t.busy_s <= 0:
        return None
    own = sum(s for k, s in t.kernel_s.items() if k in OWN_KERNELS)
    return 100.0 * own / t.busy_s
