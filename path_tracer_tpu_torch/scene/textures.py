"""Branchless batched texture evaluation.

Mirrors the reference package's `scene/textures.py`: a lane batch
evaluates every texture type and selects by type id, with per-lane
gathers from the texture table and one row gather into the uint8 image
atlas (the reference's frozen image buffer, texture.hpp:126-131).
"""
from __future__ import annotations

import torch

from ..core.rng import f32
from ..core.vec import Vec3, fsin
from ..engine.intersect import take
from . import types as T

_INV255 = f32(1.0 / 255.0)


def texture_value(textures: T.Textures, tex_id: torch.Tensor,
                  u: torch.Tensor, v: torch.Tensor, p: Vec3) -> Vec3:
    """Texture `tex_id` (per lane) at surface coords (u, v) and world hit
    point p:

    * solid: a constant colour (texture.hpp:18-29);
    * checker: sin(10x) sin(10y) sin(10z) of the WORLD hit point selects
      odd (< 0) or even (texture.hpp:42-49); each sin is libm's, evaluated
      in float64 and rounded once (`core.vec.fsin`);
    * image: nearest-neighbour atlas fetch with cyclic frequency and
      flipped v (texture.hpp:135-151), scale 1/255.

    As in the reference, texel indices out of range are clamped (the
    reference's size_t wraparound for a negative u or v is undefined).
    """
    tex_id = tex_id.long()
    ttype = take(textures.ttype, tex_id)
    c1 = Vec3(*(take(c, tex_id) for c in textures.c1))
    c2 = Vec3(*(take(c, tex_id) for c in textures.c2))

    sines = fsin(10.0 * p.x) * fsin(10.0 * p.y) * fsin(10.0 * p.z)
    odd = sines < 0.0
    checker = Vec3(torch.where(odd, c1.x, c2.x), torch.where(odd, c1.y, c2.y),
                   torch.where(odd, c1.z, c2.z))

    # size_t truncation of fmod(u*freq, 1)*(w-1), texture.hpp:139-143
    w = take(textures.width, tex_id).int()
    h = take(textures.height, tex_id).int()
    off = take(textures.offset, tex_id).int()
    freq = take(textures.freq, tex_id)
    fu = torch.fmod(u * freq, 1.0)
    fv = torch.fmod(v * freq, 1.0)
    i = torch.clamp((fu * (w - 1).float()).int(), torch.zeros_like(w), w - 1)
    j = torch.clamp(((1.0 - fv) * (h - 1).float()).int(),
                    torch.zeros_like(h), h - 1)
    pix = torch.clamp((off + j * w + i).long(), 0,
                      textures.atlas.shape[0] - 1)
    texel = take(textures.atlas, pix).float()
    image = Vec3(texel[..., 0] * _INV255, texel[..., 1] * _INV255,
                 texel[..., 2] * _INV255)

    is_checker = ttype == T.TEX_CHECKER
    is_image = ttype == T.TEX_IMAGE
    sel = lambda im, ch, so: torch.where(is_image, im,
                                         torch.where(is_checker, ch, so))
    return Vec3(sel(image.x, checker.x, c1.x), sel(image.y, checker.y, c1.y),
                sel(image.z, checker.z, c1.z))
