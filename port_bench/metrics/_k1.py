"""Shared by the K1 readers: K1's device seconds in the traced window, by
its kernel's name, and its least time there by the frozen arithmetic."""
from port_bench.roofline import k1

KERNEL = "wave_kernel"


def device_s(traced) -> float:
    return sum(v for k, v in traced["device_s"].items() if KERNEL in k)


def roofline_pct(run, kind):
    t = run["traced"]
    if t is None or run["kind"] != kind:
        return None
    segs = [u.get("segments") for u in t["units"]]
    busy = device_s(t)
    if busy <= 0.0 or None in segs or t["lanes"] == 0:
        return None
    return 100.0 * k1.bound_s(t["lanes"], sum(segs), run["rows"]) / busy
