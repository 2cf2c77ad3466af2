"""Camera ray generation for the work-queue driver.

Only `camera_rays` of the reference package's `engine/integrator.py` is
ported so far; the jnp oracle integrators are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core import rng as rng_mod
from ..core.camera import Camera
from ..core.vec import Vec3, fdiv


def camera_rays(cam: Camera, width: int, height: int,
                pix_ids: torch.Tensor, rng_state: torch.Tensor
                ) -> Tuple[torch.Tensor, Vec3, Vec3, torch.Tensor]:
    """Jittered primary rays for flat int64 pixel ids (linear = y*W + x,
    y bottom-up like the reference fb).  5 draws a lane: u, v jitter,
    then get_ray's disk (2) and time (1) — render.hpp:96-99."""
    x = (pix_ids % width).to(torch.float32)
    y = torch.div(pix_ids, width, rounding_mode="floor").to(torch.float32)
    rng_state, ju = rng_mod.next_f01(rng_state)
    rng_state, jv = rng_mod.next_f01(rng_state)
    u = fdiv(x + ju, float(width))
    v = fdiv(y + jv, float(height))
    return cam.get_ray(u, v, rng_state)
