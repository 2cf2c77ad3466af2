"""occupancy.fwd: segments traced over lane-steps launched in the traced
frames (render_wq's return_stats): the share of K1's lanes that did
work, which the drain stages decide."""


def read(run):
    t = run["traced"]
    if t is None or run["kind"] != "frames":
        return None
    steps = sum(u["lane_steps"] for u in t["units"])
    return sum(u["segments"] for u in t["units"]) / steps if steps else None
