"""Checkpointed rendering: preemption-safe sample accumulation.

The reference renders the whole frame in one kernel and writes the image
once at exit (render.hpp:151, main.cpp:194); a killed job loses
everything.  Here, as in the reference package's `engine/checkpoint.py`,
the frame is an accumulator over sample ranges: after every
``checkpoint_every`` samples the per-pixel radiance SUM (not the mean) and
its metadata land on disk, and a restarted job resumes at the first sample
not yet accumulated.  Every (pixel, sample) has its own counter-derived
stream, and the work-queue deposit adds in a fixed order, so a resumed
render equals an uninterrupted one with the same range boundaries bit for
bit, on the card as on the CPU.

The files are the reference package's: `accum.npz` holding `acc`, (N, 3)
float32, and `meta.json`, so a checkpoint either package writes, the other
reads.  The renderer ("wq", the work queue, or "jnp", the oracle engine's
chunk loop) is part of the identity, as in the reference.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.camera import Camera
from ..core.device import resolve_device
from ..core.vec import fdiv
from ..scene import types as T
from ..utils.profiling import log
from .integrator import perf_schedule, render_range, scene_on
from .wq import render_wq_range

RENDERERS = ("wq", "jnp")

# the metadata that must match for a checkpoint to be resumed
IDENTITY_KEYS = ("scene", "width", "height", "max_depth", "seed", "t_min",
                 "attenuate_emission", "renderer")


def _ckpt_paths(ckpt_dir: str) -> Tuple[str, str]:
    return (os.path.join(ckpt_dir, "accum.npz"),
            os.path.join(ckpt_dir, "meta.json"))


def _save_atomic(ckpt_dir: str, acc: np.ndarray, meta: dict) -> None:
    """Write accum + meta via rename so a crash mid-save can't corrupt."""
    os.makedirs(ckpt_dir, exist_ok=True)
    acc_path, meta_path = _ckpt_paths(ckpt_dir)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".npz.tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, acc=acc)
    os.replace(tmp, acc_path)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path)


def load_checkpoint(ckpt_dir: str, expect_meta: dict
                    ) -> Tuple[Optional[np.ndarray], int]:
    """Returns (accumulator (N, 3) or None, samples already done).  A
    checkpoint whose identity keys mismatch the requested render is ignored
    (and reported) rather than silently blended in; so is one that cannot
    be read or whose accumulator is not the frame's (N, 3) float32."""
    acc_path, meta_path = _ckpt_paths(ckpt_dir)
    if not (os.path.exists(acc_path) and os.path.exists(meta_path)):
        return None, 0
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        if any(meta.get(k) != expect_meta[k] for k in IDENTITY_KEYS):
            log.warning("checkpoint at %s is for a different render "
                        "(%s) — ignoring", ckpt_dir,
                        {k: meta.get(k) for k in IDENTITY_KEYS})
            return None, 0
        with np.load(acc_path) as z:
            acc = z["acc"]
        n = expect_meta["width"] * expect_meta["height"]
        if acc.shape != (n, 3) or acc.dtype != np.float32:
            raise ValueError(f"accumulator is {acc.dtype} {acc.shape}, not "
                             f"float32 ({n}, 3)")
        return acc, int(meta["spp_done"])
    except (OSError, EOFError, KeyError, ValueError,
            zipfile.BadZipFile) as e:      # corrupt checkpoint -> start over
        log.warning("failed to load checkpoint at %s: %s", ckpt_dir, e)
        return None, 0


def render_checkpointed(scene: T.Scene, cam: Camera, width: int, height: int,
                        spp: int, max_depth: int = 50,
                        attenuate_emission: bool = False,
                        t_min: float = 1e-3, seed: int = 0,
                        ckpt_dir: str = "", checkpoint_every: int = 50,
                        scene_name: str = "", max_lanes: int = 1 << 17,
                        renderer: str = "wq",
                        device: Union[str, torch.device] = "cuda"
                        ) -> torch.Tensor:
    """Sample-range render with periodic on-disk accumulation, the
    accumulator on the device.  renderer="wq" (default): one
    `render_wq_range` call a checkpoint range.  renderer="jnp": the
    reference's chunk loop, ranges of `render_perf`'s sample chunk under
    `max_lanes`, each range one `render_range`, saved once
    `checkpoint_every` samples have gathered.  Output (H, W, 3) radiance
    means on the device."""
    if renderer not in RENDERERS:
        raise ValueError(f"unknown renderer {renderer!r}; have {RENDERERS}")
    dev = resolve_device(device)
    n = width * height
    meta_id = {"scene": scene_name, "width": width, "height": height,
               "max_depth": max_depth, "seed": seed, "t_min": t_min,
               "attenuate_emission": attenuate_emission,
               "renderer": renderer}

    acc_np, spp_done = (None, 0)
    if ckpt_dir:
        acc_np, spp_done = load_checkpoint(ckpt_dir, meta_id)
        if spp_done > spp:
            # its sum cannot be cut back to `spp` samples
            log.warning("checkpoint at %s holds %d spp, more than the %d "
                        "asked for — starting over", ckpt_dir, spp_done, spp)
            acc_np, spp_done = None, 0
        if spp_done:
            log.info("resuming from checkpoint: %d/%d spp done",
                     spp_done, spp)
    acc = (torch.from_numpy(acc_np).to(dev) if acc_np is not None
           else torch.zeros((n, 3), dtype=torch.float32, device=dev))

    if renderer == "wq":
        spp_chunk = max(1, min(spp, checkpoint_every))  # one render a range
    else:
        scene = scene_on(scene, dev)
        spp_chunk, _ = perf_schedule(n, spp, max_lanes)
    since_ckpt = 0
    s0 = spp_done
    while s0 < spp:
        sc = min(spp_chunk, spp - s0)
        if renderer == "wq":
            acc = acc + render_wq_range(
                scene, cam, width, height, s0, sc, max_depth=max_depth,
                attenuate_emission=attenuate_emission, t_min=t_min,
                seed=seed, device=dev)
        else:
            acc = acc + render_range(scene, cam, width, height, 0, n, s0,
                                     sc, max_depth, attenuate_emission,
                                     t_min, seed, max_lanes)
        s0 += sc
        since_ckpt += sc
        if ckpt_dir and (since_ckpt >= checkpoint_every or s0 >= spp):
            _save_atomic(ckpt_dir, acc.cpu().numpy(),
                         {**meta_id, "spp_done": s0})
            log.info("checkpoint: %d/%d spp -> %s", s0, spp, ckpt_dir)
            since_ckpt = 0

    # an IEEE divide on every device, as render_wq's mean (core.vec.fdiv)
    return fdiv(acc, float(spp)).reshape(height, width, 3)
