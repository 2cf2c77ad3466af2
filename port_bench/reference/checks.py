"""The numbers that decide `correct`, worked out by the plain reference.

Each function takes the answers a run produced (the program's, or the
control's: the reference itself in a lower precision) and recomputes
them from the configuration and the seeds alone.

Frames: every answer is an image's values at a set of pixels drawn from
the run's seed, with the frame's seed and its mean segments a sample.
`img_gap` is the widest gap of a value from the reference's, over the
larger of the reference's magnitude and 1e-3; `segs_gap` is the relative
gap of the mean segments a sample (the program counts the whole frame,
the reference the drawn pixels).
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from . import scene as S
from . import tracer as R
from .fmath import fdiv

FLOOR = 1e-3


class FrameAnswer(NamedTuple):
    seed: int              # the frame's render seed
    pix: np.ndarray        # (P,) int64 pixel ids
    vals: np.ndarray       # (P, 3) float32: the image (or the preview) there
    mean_segs: float       # segments a sample


def chunk_of(spp: int, cap: int = 10) -> int:
    for c in range(min(cap, spp), 0, -1):
        if spp % c == 0:
            return c
    return 1


def frame_values(cfg, tb, cam, width, height, spp, max_depth, answers,
                 progressive: bool):
    """The reference's values at each answer's pixels, and its mean
    segments a sample over all of them."""
    dev = tb.sph.device
    P = len(answers[0].pix)
    pix = torch.from_numpy(np.stack([a.pix for a in answers])).to(dev)
    seeds = torch.tensor([a.seed for a in answers], dtype=torch.int64,
                         device=dev)
    n_f = len(answers)
    pix_l = pix.reshape(-1).repeat_interleave(spp)
    smp_l = torch.arange(spp, device=dev).repeat(n_f * P)
    seed_l = seeds.repeat_interleave(P * spp)
    rad, segs = R.trace(tb, cam, width, height, pix_l, smp_l, seed_l,
                        max_depth=max_depth)
    img = fdiv(R.pixel_sums(rad, spp, chunk_of(spp)), float(spp))
    img = img.reshape(n_f, P, 3)
    if progressive:
        acc = torch.zeros_like(img[0])
        out = []
        for n in range(n_f):
            acc = acc + img[n]
            out.append(fdiv(acc, float(n + 1)))
        img = torch.stack(out)
    return img.float().cpu().numpy(), float(segs.double().mean())


def frames(cfg, traffic: dict, answers: List[FrameAnswer], device,
           dt=torch.float32) -> dict:
    w, h = cfg.CONFIG["resolution"]
    tb = S.build(cfg, device, dt)
    cam = S.camera(cfg.CONFIG["camera"], w / h)
    ref, ref_segs = frame_values(cfg, tb, cam, w, h, traffic["spp"],
                                 cfg.CONFIG["max_depth"], answers,
                                 traffic.get("progressive", False))
    vals = np.stack([a.vals for a in answers]).astype(np.float64)
    ref = ref.astype(np.float64)
    gap = np.abs(vals - ref) / np.maximum(np.abs(ref), FLOOR)
    gap = np.where(np.isfinite(gap), gap, np.inf)
    prog_segs = float(np.mean([a.mean_segs for a in answers]))
    per_frame = gap.reshape(len(answers), -1).max(1)
    return dict(img_gap=float(gap.max()),
                segs_gap=abs(prog_segs - ref_segs) / ref_segs,
                _per_unit=per_frame.tolist())


def control_frames(cfg, traffic: dict, answers: List[FrameAnswer], device,
                   dt=torch.bfloat16) -> List[FrameAnswer]:
    """The answers the reference gives in `dt`, in the program's place."""
    w, h = cfg.CONFIG["resolution"]
    tb = S.build(cfg, device, dt)
    cam = S.camera(cfg.CONFIG["camera"], w / h)
    vals, segs = frame_values(cfg, tb, cam, w, h, traffic["spp"],
                              cfg.CONFIG["max_depth"], answers,
                              traffic.get("progressive", False))
    return [FrameAnswer(a.seed, a.pix, v, segs) for a, v in
            zip(answers, vals)]
