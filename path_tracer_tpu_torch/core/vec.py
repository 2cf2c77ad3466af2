"""Structure-of-arrays 3-vectors of float32 tensors, and float32 math with
a fixed rounding.

A batch of vectors is three same-shaped tensors, one per component, as in
the reference package's `core/vec.py`, with its helpers (`dot`,
`length_squared`, `reflect`, `refract`, `where`, `lerp`,
`grad_safe_sqrt`) in its association order.  Every op is one rounded
float32 op in the order written (PyTorch fuses nothing), so the CUDA
kernel built with `-fmad=false` reproduces these values bit for bit.

`fdiv` keeps a division by a Python number a true divide on the card.
`fsqrt`, `fsin`, `fcos`, `flog` and `ftan` pin the float32 rounding of the
transcendental functions: PyTorch's vectorised float32 CPU kernels are not
correctly rounded (its CPU `sqrt` differs from IEEE on ~0.7% of inputs),
so they evaluate in float64 and round once.  For `sqrt` that is exactly
the IEEE float32 result; for the others it is the correctly rounded value
except on inputs within ~1e-16 of a rounding boundary.  The CUDA kernel
uses the same float64 evaluation, so the two agree.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def fdiv(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d with an IEEE divide on every device: PyTorch's CUDA kernels
    turn `tensor / python_number` into a multiply by the reciprocal, which
    rounds differently; a 0-d divisor on x's device keeps the divide."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def fsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).float()


def frsqrt(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt(x) from a correctly rounded sqrt and an IEEE divide, the same
    bits on every device: CUDA's rsqrt is not correctly rounded, and a
    depth-50 replay's gradient amplifies its last bit (see PERF.md)."""
    return 1.0 / fsqrt(x)


def fsin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.double()).float()


def fcos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.double()).float()


def flog(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.double()).float()


def ftan(x: torch.Tensor) -> torch.Tensor:
    return torch.tan(x.double()).float()


def fatan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.atan2(y.double(), x.double()).float()


def fasin(x: torch.Tensor) -> torch.Tensor:
    return torch.asin(x.double()).float()


class Vec3(NamedTuple):
    """A batch of 3-vectors stored as three component tensors (SoA)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def dot(a: Vec3, b: Vec3) -> torch.Tensor:
    """Association order x + (y + z), as length_squared."""
    return a.x * b.x + (a.y * b.y + a.z * b.z)


def length_squared(v: Vec3) -> torch.Tensor:
    # association x*x + (y*y + z*z), as the reference (vec.hpp:11-13)
    return v.x * v.x + (v.y * v.y + v.z * v.z)


def length(v: Vec3) -> torch.Tensor:
    return fsqrt(length_squared(v))


def unit_vector(v: Vec3) -> Vec3:
    return v / length(v)


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def reflect(v: Vec3, n: Vec3) -> Vec3:
    # v - 2*dot(v,n)*n (vec.hpp:26)
    return v - n * (2.0 * dot(v, n))


def grad_safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(x) for x > 0, else 0, with a finite gradient at x <= 0.  The
    double `where` keeps the backward free of the inf * 0 = NaN that
    `sqrt(where(m, x, 0))` gives masked-out lanes (torch.where has the same
    trap as jnp.where)."""
    pos = x > 0.0
    return torch.where(pos, fsqrt(torch.where(pos, x, 1.0)), 0.0)


def refract(uv: Vec3, n: Vec3, etai_over_etat: torch.Tensor) -> Vec3:
    # vec.hpp:29-35; grad-safe at exact total internal reflection
    cos_theta = torch.clamp_max(-dot(uv, n), 1.0)
    r_out_perp = (uv + n * cos_theta) * etai_over_etat
    r_out_parallel = n * (-grad_safe_sqrt(
        torch.abs(1.0 - length_squared(r_out_perp))))
    return r_out_perp + r_out_parallel


def where(mask: torch.Tensor, a: Vec3, b: Vec3) -> Vec3:
    """Lane-select between two vector batches."""
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))


def lerp(a: Vec3, b: Vec3, t: torch.Tensor) -> Vec3:
    return a * (1.0 - t) + b * t

