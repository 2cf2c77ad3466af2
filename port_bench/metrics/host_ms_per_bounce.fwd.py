"""host_ms_per_bounce.fwd: the traced frames' time outside K1, a bounce:
(the traced window's seconds - K1's device seconds) over K1's launches
(the program's wave_bounce.launches), in ms.  It holds all of a frame
that is not K1: the windowed driver's refill, texel service, deposit and
compaction, `pack_scene` on each `render_wq` call, the image's copy to
the host, the running mean and the tone map."""
from port_bench.metrics import _k1


def read(run):
    t = run["traced"]
    if t is None or run["kind"] != "frames" or t["launches"] == 0:
        return None
    return 1e3 * (t["window_s"] - _k1.device_s(t)) / t["launches"]
