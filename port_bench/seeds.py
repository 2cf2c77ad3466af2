"""Everything a run draws, drawn from `--seed`: render seeds and the
pixels the reference recomputes.  The same seed gives the same draws;
each draw has a tag of its own, so adding one moves no other."""
from __future__ import annotations

import zlib

import numpy as np


def _seq(seed: int, tag: str, *idx: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) % 2 ** 64,
                                   zlib.crc32(tag.encode()), *idx])


def frame(seed: int, tag: str, i: int) -> int:
    """A 32-bit render seed."""
    return int(_seq(seed, tag, i).generate_state(1, np.uint32)[0])


def pixels(seed: int, tag: str, n_pix: int, n: int, i: int = 0) -> np.ndarray:
    """`n` distinct pixel ids of `n_pix`, ascending."""
    rng = np.random.default_rng(_seq(seed, tag, i))
    return np.sort(rng.choice(n_pix, size=n, replace=False)).astype(np.int64)
