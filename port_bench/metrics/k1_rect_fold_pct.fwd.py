"""k1_rect_fold_pct.fwd: the share of K1's cycles that its rect fold
takes: 100 x the rect fold's cycles over the cycles of all five phases
of the program's counter `wave_bounce.phase_cycles` (the sphere fold,
the rect fold, the triangle fold, merge and media, the rest; clock64()
spans of warp 0 of each block, summed over every K1 launch of the
windowed driver in the process, the warm-up frame's among them).  None
where the program has no such counter or counted nothing (the plain
version on the CPU)."""
import sys

RECT = 1   # the rect fold's place in wave_bounce.PHASES


def read(run):
    wb = sys.modules.get("path_tracer_tpu_torch.ops.wave_bounce")
    if run["kind"] != "frames" or wb is None:
        return None
    cycles = getattr(wb.wave_bounce, "phase_cycles", None)
    total = sum(cycles) if cycles else 0
    return 100.0 * cycles[RECT] / total if total > 0 else None
