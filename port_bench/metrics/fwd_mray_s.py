"""fwd_mray_s: traced path segments of every frame in the window, in
millions, over the window's seconds (host clock; each frame ends with
its tone-mapped image on the host)."""


def read(run):
    if run["kind"] != "frames":
        return None
    return sum(u["segments"] for u in run["units"]) / run["window_s"] / 1e6
