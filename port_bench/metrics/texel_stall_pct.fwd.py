"""texel_stall_pct.fwd: the share of lane-bounces with a pending
image-texture fixup that the windowed driver's texel service left
uncovered, so that the lane stalled in K1 that bounce: 100 x the
program's counters `wq_window_fb.texel_stalled / .texel_pending`, over
every window the process ran (the warm-up frame's among them).  None
where the program has no such counters or nothing was pending (a scene
without image textures)."""
import sys


def read(run):
    wq = sys.modules.get("path_tracer_tpu_torch.engine.wq")
    if run["kind"] != "frames" or wq is None:
        return None
    pending = getattr(wq.wq_window_fb, "texel_pending", 0)
    stalled = getattr(wq.wq_window_fb, "texel_stalled", 0)
    return 100.0 * stalled / pending if pending else None
