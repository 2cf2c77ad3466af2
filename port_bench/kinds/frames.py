"""Frames: `render_wq` of the configuration's scene, back to back, each
with its own render seed; with `progressive`, each frame is one pass
added to a running mean (an interactive preview).  A unit ends with the
tone-mapped image on the host.

Traffic keys: `spp` (samples a pixel a frame), `progressive`,
`check_pixels` (pixels a frame whose values the reference recomputes),
`trace_units`.  The frame's size is the configuration's `resolution`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import seeds
from port_bench.reference import checks


class State:
    pass


def setup(ctx) -> State:
    from path_tracer_tpu_torch.core.vec import fdiv
    from path_tracer_tpu_torch.engine.wq import render_wq
    from path_tracer_tpu_torch.utils.image import tonemap
    from port_bench import scene
    tr = ctx.traffic
    s = State()
    s.ctx, s.render, s.tonemap, s.fdiv = ctx, render_wq, tonemap, fdiv
    s.w, s.h = ctx.cfg.CONFIG["resolution"]
    s.scene, s.cam = scene.build(ctx.cfg, s.w, s.h, ctx.device)
    s.n_pix = s.w * s.h
    s.P = min(tr["check_pixels"], s.n_pix)
    s.fixed = seeds.pixels(ctx.seed, "preview", s.n_pix, s.P)
    # warm-up: one frame of the window's shape, with a seed of its own
    s.acc, s.n_acc = None, 0
    _frame(s, seeds.frame(ctx.seed, "warm", 0), None)
    s.acc, s.n_acc = None, 0
    return s


def _frame(s: State, seed: int, pix):
    tr = s.ctx.traffic
    img, segs, iters, lane_steps = s.render(
        s.scene, s.cam, s.w, s.h, tr["spp"],
        max_depth=s.ctx.cfg.CONFIG["max_depth"], seed=seed,
        return_stats=True, device=s.ctx.device)
    if tr.get("progressive"):
        s.acc = img if s.acc is None else s.acc + img
        s.n_acc += 1
        img = s.fdiv(s.acc, float(s.n_acc))
    host = img.cpu().numpy()
    s.tonemap(host)     # the image the user is shown: part of the frame
    vals = None if pix is None else host.reshape(-1, 3)[pix].copy()
    return vals, float(segs), int(iters), float(lane_steps)


def unit(s: State, i: int) -> dict:
    t0 = time.perf_counter()
    seed = seeds.frame(s.ctx.seed, "frame", i)
    prog = s.ctx.traffic.get("progressive")
    pix = s.fixed if prog else seeds.pixels(s.ctx.seed, "frame", s.n_pix,
                                            s.P, i)
    vals, segs, iters, lane_steps = _frame(s, seed, pix)
    return dict(t=time.perf_counter() - t0, seed=seed, pix=pix, vals=vals,
                segments=segs, iters=iters, lane_steps=lane_steps,
                samples=s.n_pix * s.ctx.traffic["spp"])


def release(s: State) -> None:
    s.scene = s.cam = s.acc = s.render = None


def answers(records) -> list:
    return [checks.FrameAnswer(r["seed"], r["pix"], r["vals"],
                               r["segments"] / r["samples"]) for r in records]


def check(s: State, records) -> dict:
    ctx = s.ctx
    return checks.frames(ctx.cfg, ctx.traffic, answers(records), ctx.device)


def control(ctx, n_units: int, dt=torch.bfloat16) -> dict:
    """The numbers of the reference in `dt` put in the program's place,
    over the first `n_units` frames a run of this seed draws."""
    tr = ctx.traffic
    w, h = ctx.cfg.CONFIG["resolution"]
    P = min(tr["check_pixels"], w * h)
    fixed = seeds.pixels(ctx.seed, "preview", w * h, P)
    recs = [dict(seed=seeds.frame(ctx.seed, "frame", i),
                 pix=fixed if tr.get("progressive")
                 else seeds.pixels(ctx.seed, "frame", w * h, P, i),
                 vals=None, segments=0.0, samples=1) for i in range(n_units)]
    ans = checks.control_frames(ctx.cfg, tr, answers(recs), ctx.device, dt)
    return {"control": checks.frames(ctx.cfg, tr, ans, ctx.device)}
