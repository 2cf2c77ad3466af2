"""Lockstep xorshift32 streams with the reference's sampling transforms.

Mirrors the reference package's `core/rng.py`: one 32-bit xorshift state per
lane (xorshift.hpp:72-74), masked advancement so per-event draw counts match
the reference, and the reference's non-uniform unit-vector, disk and ball
transforms (rtweekend.hpp:60-88).

The 32-bit state is carried as int64 holding a value in [0, 2**32): torch's
uint32 has no shifts or adds on the CPU.  Every op below keeps values
inside that range (splitmix32's products stay below 2**63).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .vec import Vec3, fcos, fsin, fsqrt

PI = 3.1415926535897932385  # rtweekend.hpp:22
INITIAL_STATE = 2463534242  # xorshift.hpp:18
MASK32 = 0xFFFFFFFF
_F32_SCALE = 2.0 ** -32


def f32(x: float) -> float:
    """A Python float holding the float32 rounding of x (exact in f32)."""
    return float(np.float32(x))


def xs32_step(state: torch.Tensor) -> torch.Tensor:
    """One xorshift32 update (xorshift.hpp:72-74)."""
    state = state ^ (state >> 7)
    state = state ^ ((state << 1) & MASK32)
    state = state ^ (state >> 9)
    return state


def u32_to_f01(u: torch.Tensor) -> torch.Tensor:
    """u32 -> [0, 1] float as the C++ `generator() * 2^-32`: one
    round-to-nearest conversion, then an exact scale."""
    return u.to(torch.float32) * _F32_SCALE


def _masked(new: torch.Tensor, old: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    return new if mask is None else torch.where(mask, new, old)


def next_f01(state: torch.Tensor, mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw a float in [0, 1]; masked-off lanes keep their state (their
    value is garbage)."""
    s2 = xs32_step(state)
    return _masked(s2, state, mask), u32_to_f01(s2)


def next_frange(state: torch.Tensor, lo: float, hi: float,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """lo + (hi - lo) * f with float32 bounds (rtweekend.hpp:45-48)."""
    state, f = next_f01(state, mask)
    lo32 = f32(lo)
    return state, lo32 + f32(np.float32(hi) - np.float32(lo)) * f


def next_frange_dyn(state: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float_t(min, max) with per-lane bounds."""
    state, f = next_f01(state, mask)
    return state, lo + (hi - lo) * f


def next_vec(state: torch.Tensor, mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Vec3]:
    """vec_t(): three sequential draws (rtweekend.hpp:51)."""
    state, x = next_f01(state, mask)
    state, y = next_f01(state, mask)
    state, z = next_f01(state, mask)
    return state, Vec3(x, y, z)


def next_unit_vec(state: torch.Tensor, mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Vec3]:
    """The reference's non-uniform unit vector (rtweekend.hpp:60-67);
    3 draws."""
    state, x = next_frange(state, -1.0, 1.0, mask)
    maxy = fsqrt(1.0 - x * x)
    state, y = next_frange_dyn(state, -maxy, maxy, mask)
    absz = fsqrt(maxy * maxy - y * y)
    state, u = next_f01(state, mask)
    return state, Vec3(x, y, torch.where(u > 0.5, absz, -absz))


def next_in_unit_ball(state: torch.Tensor,
                      mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Vec3]:
    """Polar ball sample, not volume-uniform (rtweekend.hpp:70-80);
    3 draws."""
    state, r = next_f01(state, mask)
    state, theta = next_frange(state, 0.0, 2.0 * PI, mask)
    state, phi = next_frange(state, 0.0, PI, mask)
    plan = r * fsin(phi)
    return state, Vec3(plan * fcos(theta), plan * fsin(theta), r * fcos(phi))


def next_in_unit_disk(state: torch.Tensor,
                      mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Vec3]:
    """x, then y bounded by x: not area-uniform (rtweekend.hpp:83-88);
    2 draws."""
    state, x = next_frange(state, -1.0, 1.0, mask)
    maxy = fsqrt(1.0 - x * x)
    state, y = next_frange_dyn(state, -maxy, maxy, mask)
    return state, Vec3(x, y, torch.zeros_like(x))


def seed_parity(linear_ids: torch.Tensor) -> torch.Tensor:
    """Per-pixel seed as render.hpp:130-131: libstdc++'s
    std::hash<size_t> is the identity, cut to the 32-bit state.  Pixel 0
    therefore gets state 0, whose xorshift stream is all zeros: a
    reference quirk kept here."""
    return linear_ids.long() & MASK32


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit splitmix hash for stream seeding."""
    x = (x + 0x9E3779B9) & MASK32
    x = ((x ^ (x >> 16)) * 0x21F0AAAD) & MASK32
    x = ((x ^ (x >> 15)) * 0x735A2D97) & MASK32
    return x ^ (x >> 15)


def seed_perf(pixel_ids: torch.Tensor, sample_ids: torch.Tensor,
              base_seed: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """Counter-based stream seed per (pixel, sample),
    splitmix32(pix ^ splitmix32(sample ^ seed)); never 0 (the xorshift
    fixed point).  The one stream seed of the package: the work queue's
    grants, K1's in-chunk regeneration and both gradient routes.
    `base_seed` is an int or an int64 tensor such as the 0-d device word
    K1 reads (`SceneTables.seed`), which is not read back to the host, so
    a CUDA graph can capture the call."""
    h = splitmix32((pixel_ids & MASK32)
                   ^ splitmix32((sample_ids & MASK32)
                                ^ (base_seed & MASK32)))
    return torch.where(h == 0, torch.full_like(h, INITIAL_STATE), h)
