"""Thin-lens camera with depth of field and motion blur (camera.hpp:19-101).

Mirrors the reference package's `core/camera.py`: the same float32 values
computed in the same operation order.  The camera is a NamedTuple of 0-d
float32 tensors on the CPU (host constants, like the reference's
construction-time fields); `get_ray` broadcasts them against lane tensors
on any device.  Directions are not normalized (camera.hpp:96-98).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import rng as rng_mod
from .vec import Vec3, cross, ftan, unit_vector


def _scalar(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


def _as_vec(p) -> Vec3:
    x, y, z = p
    return Vec3(_scalar(x), _scalar(y), _scalar(z))


class Camera(NamedTuple):
    origin: Vec3
    lower_left_corner: Vec3
    horizontal: Vec3
    vertical: Vec3
    u: Vec3
    v: Vec3
    w: Vec3
    lens_radius: torch.Tensor
    time0: torch.Tensor
    time1: torch.Tensor

    @staticmethod
    def create(look_from, look_at, vup, vfov_deg, aspect_ratio, aperture,
               focus_dist, time0=0.0, time1=0.0) -> "Camera":
        """camera.hpp:67-91, all float32."""
        look_from = _as_vec(look_from)
        look_at = _as_vec(look_at)
        vup = _as_vec(vup)
        theta = _scalar(vfov_deg) * _scalar(rng_mod.PI) / _scalar(180.0)
        h = ftan(theta / 2.0)
        viewport_height = 2.0 * h
        viewport_width = _scalar(aspect_ratio) * viewport_height
        focus_dist = _scalar(focus_dist)

        w = unit_vector(look_from - look_at)
        u = unit_vector(cross(vup, w))
        v = cross(w, u)
        horizontal = u * (focus_dist * viewport_width)
        vertical = v * (focus_dist * viewport_height)
        lower_left_corner = (look_from - horizontal * 0.5 - vertical * 0.5
                             - w * focus_dist)
        return Camera(origin=look_from, lower_left_corner=lower_left_corner,
                      horizontal=horizontal, vertical=vertical, u=u, v=v, w=w,
                      lens_radius=_scalar(aperture) / 2.0,
                      time0=_scalar(time0), time1=_scalar(time1))

    def get_ray(self, s: torch.Tensor, t: torch.Tensor, state: torch.Tensor
                ) -> Tuple[torch.Tensor, Vec3, Vec3, torch.Tensor]:
        """camera.hpp:93-100 over a lane batch: 3 draws (disk 2, time 1).
        Returns (rng', origin, direction, time)."""
        state, rd = rng_mod.next_in_unit_disk(state)
        rd = rd * self.lens_radius
        offset = self.u * rd.x + self.v * rd.y
        origin = self.origin + offset
        direction = (self.lower_left_corner + self.horizontal * s
                     + self.vertical * t - self.origin - offset)
        state, time = rng_mod.next_frange_dyn(state, self.time0, self.time1)
        return state, origin, direction, time
