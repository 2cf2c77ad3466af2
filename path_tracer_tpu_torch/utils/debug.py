"""Numerical-safety checks on renders.

NaN and Inf can enter a render through a negative sqrt argument, 0/0 in a
masked lane or log(0) in the smoke sampler, and then spread through every
later sample of the pixel; an index past a table reads another
primitive's data, or faults on the card.  `assert_image_finite` is the
cheap check after a render.  `checked_render` renders a small frame
through the oracle engine with checks at every bounce: where the
reference package jit-compiles the render under `jax.experimental.
checkify` (float and index checks) and raises its error, this one checks
between the engine's steps on the host and raises `IndexError` or
`FloatingPointError` naming the sample, the bounce and what failed.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.camera import Camera
from ..core.device import resolve_device
from ..core.vec import Vec3, fdiv
from ..scene import types as T


def assert_image_finite(img, what: str = "image") -> None:
    """Raise with the first bad pixels if an image (tensor or array) has
    NaN or Inf components."""
    arr = (img.detach().cpu().numpy() if isinstance(img, torch.Tensor)
           else np.asarray(img))
    bad = ~np.isfinite(arr)
    if bad.any():
        idx = np.argwhere(bad.any(axis=-1) if arr.ndim == 3 else bad)[:8]
        raise FloatingPointError(
            f"{what} has {int(bad.sum())} non-finite components; first bad "
            f"pixels (row, col): {idx.tolist()}")


def _check_range(what: str, idx: torch.Tensor, size: int, where: str):
    bad = (idx < 0) | (idx >= size)
    if bool(bad.any()):
        raise IndexError(f"{where}: {int(bad.sum())} lanes index {what} "
                         f"outside [0, {size}), e.g. "
                         f"{idx[bad][:4].tolist()}")


def _check_finite(state, where: str):
    for name in ("o", "d", "throughput", "radiance"):
        v = getattr(state, name)
        for c, x in zip("xyz", v):
            bad = ~torch.isfinite(x)
            if bool(bad.any()):
                raise FloatingPointError(
                    f"{where}: {name}.{c} is non-finite on {int(bad.sum())} "
                    f"lanes, e.g. lanes {torch.nonzero(bad)[:4, 0].tolist()}")
    if not bool(torch.isfinite(state.time).all()):
        raise FloatingPointError(f"{where}: time is non-finite")


def checked_render(scene: T.Scene, cam: Camera, width: int, height: int,
                   spp: int, max_depth: int = 8,
                   attenuate_emission: bool = False, t_min: float = 1e-3,
                   seed: int = 0, device: Union[str, torch.device] = "cuda"
                   ) -> torch.Tensor:
    """Render a small frame through the oracle engine (`trace`'s bounces,
    exact spheres, the perf streams) with a check at every bounce:

    * index ranges before the gathers the bounce makes with ids read
      from the scene: the winner's material id into the material table
      and that material's texture id into the texture table (IndexError;
      the winner's own index and the atlas texel are clamped by the
      engine, as in the reference);
    * every lane's origin, direction, time, throughput and radiance
      finite after the bounce (FloatingPointError).

    Returns the (H, W, 3) mean image on `device`.  Several host syncs a
    bounce: a debugging tool, sized for debugging configs."""
    from ..engine.integrator import (PathState, _shade, camera_rays,
                                     scene_on)
    from ..engine.intersect import intersect_scene
    dev = resolve_device(device)
    scene = scene_on(scene, dev)
    n_mat = scene.materials.mtype.shape[0]
    n_tex = scene.textures.ttype.shape[0]
    n = width * height
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for s in range(spp):
        state = rng_mod.seed_perf(pix, torch.full_like(pix, s), seed)
        state, o, d, t = camera_rays(cam, width, height, pix, state)
        zero, one = torch.zeros_like(o.x), torch.ones_like(o.x)
        st = PathState(o, d, t, state, Vec3(one, one, one),
                       Vec3(zero, zero, zero),
                       torch.ones_like(o.x, dtype=torch.bool))
        _check_finite(st, f"sample {s}, camera rays")
        for b in range(max_depth):
            if not bool(st.alive.any()):
                break
            where = f"sample {s}, bounce {b}"
            rng, hit = intersect_scene(scene, st.o, st.d, st.time, st.rng,
                                       st.alive, t_min, True)
            h = hit.hit & st.alive
            _check_range("the materials", hit.mat[h], n_mat, where)
            _check_range("the textures",
                         scene.materials.tex[hit.mat[h].long()], n_tex,
                         where)
            st = _shade(scene, st, rng, hit, attenuate_emission)
            _check_finite(st, where)
        acc = acc + torch.stack(list(st.radiance), dim=-1)
    return fdiv(acc, float(spp)).reshape(height, width, 3)
