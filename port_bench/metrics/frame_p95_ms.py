"""frame_p95_ms: the 95th percentile of the window's frame times, each
from the frame's own start to its image on the host (linear
interpolation between order statistics)."""
import numpy as np


def read(run):
    if run["kind"] != "frames":
        return None
    return float(np.percentile([u["t"] for u in run["units"]], 95)) * 1e3
