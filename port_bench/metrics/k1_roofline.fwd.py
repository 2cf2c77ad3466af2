"""k1_roofline.fwd: K1's least time by the frozen arithmetic
(roofline/k1.py: the lanes of each launch, from the program's
wave_bounce.events, and the segments traced) over its device time by
kernel name in the traced window, as a share."""
from port_bench.metrics import _k1


def read(run):
    return _k1.roofline_pct(run, "frames")
