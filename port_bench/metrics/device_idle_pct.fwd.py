"""device_idle_pct.fwd: the share of the traced window in which nothing
ran on the device: 1 - (union of the device's kernel, copy and set
intervals inside the window) / (the window), from the profiler."""


def read(run):
    t = run["traced"]
    if t is None or run["kind"] != "frames" or t["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
