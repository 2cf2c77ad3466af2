"""The work of the bounce kernel K1 (`ops/csrc/wave_bounce.cu`), frozen
from the program's `chip_smoke.py:k1_bound` and `fold_ops_per_lane` so
that no later change to the program moves the yardstick.

One launch reads each lane's state planes once and writes each output
once: 20 read-write float planes, 3 read-only float planes, 5 fixup
planes, the texel and service planes, and the int64 RNG state in; 20
float planes, 5 fixup planes, the win and t_hit planes and the RNG state
out.  A lane that advances does the intersection folds over every table
row, counted from the kernel source: a static sphere 17 float ops (c-o 3,
b 5, c 6, disc 3), a moving one 25 (+ the centre at its time, 8), a rect
27, a triangle 40, a medium 60.  The rows are those the program packs:
each class padded to a multiple of 8 (spheres' padding is static), media
at least one.
"""
from __future__ import annotations

from . import h100

N_RW, N_RO, N_FIX, N_SIDE = 20, 3, 5, 2
BYTES_PER_LANE = (4 * (N_RW + N_RO + N_FIX + N_SIDE) + 8
                  + 4 * (N_RW + N_FIX + 2) + 8)


def fold_ops_per_lane(rows: dict) -> int:
    """Float ops of one advancing lane's folds over `rows` (static,
    moving, rect, tri, med)."""
    return (17 * rows["static"] + 25 * rows["moving"] + 27 * rows["rect"]
            + 40 * rows["tri"] + 60 * rows["med"])


def bound_s(lanes: int, advancing: int, rows: dict) -> float:
    """Least time the launches can take: `lanes` summed over launches,
    `advancing` the lanes that advanced (the segments traced), at the
    published peaks, the larger of the bytes and the operations bound.
    Summing first makes this at most the sum of the launches' own
    bounds."""
    return max(lanes * BYTES_PER_LANE / h100.HBM_BYTES_S,
               advancing * fold_ops_per_lane(rows) / h100.FP32_FLOP_S)
