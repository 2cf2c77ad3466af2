"""Branchless batched material scatter: the five reference materials
(material.hpp) evaluated lane-parallel and selected by material id.

Mirrors the reference package's `engine/scatter.py`, RNG-draw accounting
included: each lane draws only what its own material would, through
masked advancement with disjoint per-material masks —

* lambertian: 3 (unit_vec, material.hpp:21);
* metal: 3 (in_unit_ball, material.hpp:43, drawn even when fuzz == 0);
* dielectric: 1 iff refraction is possible (the C++ short circuit of
  material.hpp:80-84 skips the Fresnel draw when it cannot refract);
* lightsource: 0 (material.hpp:104);
* isotropic: 3 (in_unit_ball, material.hpp:122).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core import rng as rng_mod
from ..core.vec import (Vec3, dot, grad_safe_sqrt, reflect, refract,
                        unit_vector, where as vwhere)
from ..scene import types as T
from ..scene.textures import texture_value
from .intersect import Hit, take


class Scatter(NamedTuple):
    direction: Vec3              # new ray direction (origin is hit.p)
    attenuation: Vec3            # multiplier applied to the throughput
    emitted: Vec3                # nonzero for lights only
    did_scatter: torch.Tensor    # bool: False ends the path


def _pow5(x: torch.Tensor) -> torch.Tensor:
    """(1 - cos)^5 as a multiply chain, as the reference package and its
    NumPy oracle write it."""
    x2 = x * x
    return x2 * x2 * x


def scatter(scene: T.Scene, hit: Hit, rd_in: Vec3, rng_state: torch.Tensor,
            lane_mask: torch.Tensor) -> Tuple[torch.Tensor, Scatter]:
    """lane_mask = alive & hit.hit; other lanes draw nothing and their
    outputs mean nothing."""
    mats = scene.materials
    mi = hit.mat.long()
    mtype = take(mats.mtype, mi)
    mcolor = Vec3(*(take(c, mi) for c in mats.color))
    mparam = take(mats.param, mi)
    mtex = take(mats.tex, mi)

    is_lam = mtype == T.MAT_LAMBERTIAN
    is_metal = mtype == T.MAT_METAL
    is_diel = mtype == T.MAT_DIELECTRIC
    is_light = mtype == T.MAT_LIGHT

    # one texture fetch serves lambertian / isotropic albedo and emission
    tex_val = texture_value(scene.textures, mtex, hit.u, hit.v, hit.p)
    n = hit.normal

    # lambertian (material.hpp:18-28): normal + unit_vec
    rng_state, uvec = rng_mod.next_unit_vec(rng_state, lane_mask & is_lam)
    dir_lam = n + uvec

    # metal (material.hpp:39-48): reflect(unit(d_in), n) + fuzz * ball
    rng_state, ball_m = rng_mod.next_in_unit_ball(rng_state,
                                                  lane_mask & is_metal)
    ud = unit_vector(rd_in)
    dir_metal = reflect(ud, n) + ball_m * mparam
    metal_alive = dot(dir_metal, n) > 0.0    # material.hpp:47

    # dielectric (material.hpp:68-89).  Other lanes have param 0 (metal
    # fuzz / unused): 1/0 would make r0 NaN and poison the gradients,
    # though the lane is masked, so a harmless index stands in
    ior = torch.where(is_diel, mparam, 1.5)
    refraction_ratio = torch.where(hit.front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp_max(-dot(ud, n), 1.0)
    sin_theta = grad_safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = refraction_ratio * sin_theta > 1.0
    r0 = (1.0 - refraction_ratio) / (1.0 + refraction_ratio)
    r0 = r0 * r0
    reflectance = r0 + (1.0 - r0) * _pow5(1.0 - cos_theta)
    # the C++ short circuit: the Fresnel draw only when it can refract
    diel_draw = lane_mask & is_diel & ~cannot_refract
    rng_state, uni = rng_mod.next_f01(rng_state, diel_draw)
    choose_reflect = cannot_refract | (diel_draw & (reflectance > uni))
    dir_diel = vwhere(choose_reflect, reflect(ud, n),
                      refract(ud, n, refraction_ratio))

    # isotropic (material.hpp:118-127): a ball sample
    rng_state, dir_iso = rng_mod.next_in_unit_ball(
        rng_state, lane_mask & (mtype == T.MAT_ISOTROPIC))

    sel = lambda a, b, c, d: torch.where(
        is_lam, a, torch.where(is_metal, b, torch.where(is_diel, c, d)))
    direction = Vec3(sel(dir_lam.x, dir_metal.x, dir_diel.x, dir_iso.x),
                     sel(dir_lam.y, dir_metal.y, dir_diel.y, dir_iso.y),
                     sel(dir_lam.z, dir_metal.z, dir_diel.z, dir_iso.z))

    tex_or_col = vwhere(is_metal | is_diel, mcolor, tex_val)
    one = torch.ones_like(hit.t)
    zero = torch.zeros_like(hit.t)
    attenuation = vwhere(is_light, Vec3(one, one, one), tex_or_col)
    emitted = vwhere(is_light, tex_val, Vec3(zero, zero, zero))
    did_scatter = torch.where(
        is_light, False, torch.where(is_metal, metal_alive, True)) & lane_mask
    return rng_state, Scatter(direction=direction, attenuation=attenuation,
                              emitted=emitted, did_scatter=did_scatter)
