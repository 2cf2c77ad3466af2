"""Float and random-number arithmetic of the plain reference.

Written from the upstream's definitions (xorshift.hpp:72-74,
rtweekend.hpp:33-88) with a fixed rounding: every float op is one op of
the working dtype in the order written; sqrt, sin, cos, log and tan are
evaluated in float64 and rounded once; a division by a Python number is a
true divide (CUDA turns `tensor / number` into a multiply by the
reciprocal).  The 32-bit xorshift state is an int64 holding [0, 2**32).
"""
from __future__ import annotations

import numpy as np
import torch

PI = 3.1415926535897932385
INITIAL_STATE = 2463534242
MASK32 = 0xFFFFFFFF
F32_SCALE = 2.0 ** -32


def f32(x: float) -> float:
    """The float32 rounding of x as a Python float."""
    return float(np.float32(x))


def fdiv(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _f64(fn):
    def g(x: torch.Tensor) -> torch.Tensor:
        return fn(x.double()).to(x.dtype)
    return g


fsqrt = _f64(torch.sqrt)
fsin = _f64(torch.sin)
fcos = _f64(torch.cos)
flog = _f64(torch.log)
ftan = _f64(torch.tan)


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    x = (x + 0x9E3779B9) & MASK32
    x = ((x ^ (x >> 16)) * 0x21F0AAAD) & MASK32
    x = ((x ^ (x >> 15)) * 0x735A2D97) & MASK32
    return x ^ (x >> 15)


def stream_seed(pix: torch.Tensor, sample: torch.Tensor, seed):
    """The per-(pixel, sample) xorshift seed, never 0; `seed` the frame's
    (an int, or an int64 tensor of one a lane)."""
    seed = seed & MASK32 if torch.is_tensor(seed) else int(seed) & MASK32
    h = splitmix32((pix & MASK32) ^ splitmix32((sample & MASK32) ^ seed))
    return torch.where(h == 0, torch.full_like(h, INITIAL_STATE), h)


def xs32(s: torch.Tensor) -> torch.Tensor:
    s = s ^ (s >> 7)
    s = s ^ ((s << 1) & MASK32)
    return s ^ (s >> 9)


def draw(state, dt, mask=None):
    """(state', f in [0, 1]): lanes off `mask` keep their state."""
    s2 = xs32(state)
    f = (s2.to(torch.float32) * F32_SCALE).to(dt)
    return (s2 if mask is None else torch.where(mask, s2, state)), f


def draw_range(state, lo: float, hi: float, dt, mask=None):
    state, f = draw(state, dt, mask)
    return state, f32(lo) + f32(np.float32(hi) - np.float32(lo)) * f
