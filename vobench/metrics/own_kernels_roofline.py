"""The program's own kernels' share of their roofline in the traced slice:
the sum of their least times (roofline.py, at the configuration's launch
shapes, for each launch the trace shows) over the sum of their traced
device times."""
from vobench import roofline


def read(rec, cell):
    t = rec.trace
    if t is None:
        return None
    cfg = cell["cfg"]
    shapes = roofline.ini_shapes(cell["ini"])
    per = roofline.frame_launches(cfg["camera"]["height"], cfg["camera"]["width"],
                                  lanes=rec.lanes, **shapes)
    least = spent = 0.0
    for name, bounds in per.items():
        n = t.kernel_n.get(name, 0)
        if n:
            least += n * sum(bounds) / len(bounds)
            spent += t.kernel_s[name]
    return 100.0 * least / spent if spent > 0 else None
