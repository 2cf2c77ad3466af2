"""Structure-of-arrays 3-vectors of float32 tensors, and float32 math with
a fixed rounding.

A batch of vectors is three same-shaped tensors, one per component, as in
the reference package's `core/vec.py`; only what the port's render path
uses is here.  Every op is one rounded float32 op in the order written
(PyTorch fuses nothing), so the CUDA kernel built with `-fmad=false`
reproduces these values bit for bit.

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


def fsin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.double()).float()


def fcos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.double()).float()


def flog(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.double()).float()


def ftan(x: torch.Tensor) -> torch.Tensor:
    return torch.tan(x.double()).float()


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


def length(v: Vec3) -> torch.Tensor:
    # association x*x + (y*y + z*z), as the reference (vec.hpp:11-13)
    return fsqrt(v.x * v.x + (v.y * v.y + v.z * v.z))


def unit_vector(v: Vec3) -> Vec3:
    return v / length(v)


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)

