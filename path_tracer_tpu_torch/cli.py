"""Command-line renderer, the app layer (reference: src/main.cpp:61-197).

Mirrors the reference package's `cli.py`.  Where the reference hard-codes
one scene, one size, 100 spp and depth 50, every knob here is a flag, and
the five staged preset scenes replace the single built-in one.  The
renderers are the reference's: `wq`, the work queue, whose bounces on the
card go through the CUDA kernel `ops/csrc/wave_bounce.cu`; and the oracle
engine's `wavefront`, `fused`, `perf` and `parity` (torch ops).  `auto`
runs `wq` on CUDA and `wavefront` on the CPU, as the reference's
`resolve_auto_renderer` runs its megakernel on accelerators and its jnp
loop on the CPU; `bench` follows the same rule.  `--device` (default
cuda) stands where the reference package reads `JAX_PLATFORMS`; without
CUDA, `render` and `bench` raise unless given `--device cpu`.

    python -m path_tracer_tpu_torch render --scene final_scene --spp 100 -o out.png
    python -m path_tracer_tpu_torch render --scene cornell_box --device cpu
    python -m path_tracer_tpu_torch render --scene cornell_box --renderer perf
    python -m path_tracer_tpu_torch info
    python -m path_tracer_tpu_torch bench --scene three_spheres
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Tuple

import torch

from . import __version__
from .config import DEVICES, RENDERERS, RenderConfig
from .core.camera import Camera
from .core.device import resolve_device
from .engine.checkpoint import render_checkpointed
from .engine.integrator import (render_fused, render_parity, render_perf,
                                render_wavefront)
from .engine.wq import render_wq
from .scene.presets import PRESETS, build_final_scene
from .scene.types import Scene
from .utils import profiling
from .utils.image import dump_ppm, save_png


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="path_tracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to PNG")
    r.add_argument("--scene", default="final_scene",
                   help="preset name (see `info`)")
    r.add_argument("--width", type=int, default=None)
    r.add_argument("--height", type=int, default=None)
    r.add_argument("--spp", type=int, default=None,
                   help="samples per pixel")
    r.add_argument("--max-depth", type=int, default=None,
                   help="bounce depth (reference: 50, render.hpp:144)")
    r.add_argument("--renderer", default="auto", choices=list(RENDERERS),
                   help="launch strategy: wq = windowed work queue (its "
                        "CUDA kernel, the auto default on cuda); "
                        "wavefront = the oracle bounce loop (auto default "
                        "on cpu); fused, perf = chunked oracle loops; "
                        "parity = the reference's RNG streams")
    r.add_argument("--device", default="cuda", choices=list(DEVICES),
                   help="cuda: the card (K1 for wq); cpu: plain PyTorch "
                        "(K1's plain version for wq)")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--t-min", type=float, default=1e-3)
    r.add_argument("--attenuate-emission", action="store_true",
                   help="physically-correct emission instead of the "
                        "reference's unattenuated-return quirk")
    r.add_argument("-o", "--out", default="out.png")
    r.add_argument("--ppm", action="store_true",
                   help="also dump P3 PPM to stdout (main.cpp:17-31)")
    r.add_argument("--checkpoint-dir", default="",
                   help="save/resume partial sample accumulators here")
    r.add_argument("--checkpoint-every", type=int, default=50,
                   help="spp between checkpoints")
    r.add_argument("--profile-dir", default="",
                   help="write a torch.profiler Chrome trace here")
    r.add_argument("--metrics", action="store_true",
                   help="print a JSON metrics line when done")

    sub.add_parser("info", help="list presets, devices, build info")

    b = sub.add_parser("bench", help="throughput benchmark (one JSON line)")
    b.add_argument("--scene", default="final_scene", choices=list(PRESETS))
    b.add_argument("--spp", type=int, default=None,
                   help="default: 40 on cuda, 2 on cpu")
    b.add_argument("--device", default="cuda", choices=list(DEVICES))
    return ap


def resolve_auto_renderer(device: torch.device) -> str:
    """What `--renderer auto` runs: the work queue on CUDA (the path
    `chip_smoke.py` measures), the wavefront engine on the CPU."""
    return "wq" if device.type == "cuda" else "wavefront"


def preset_scene(name: str, width: int, height: int, device
                 ) -> Tuple[Scene, Camera]:
    """The preset's scene and camera on `device`; the final scene's camera
    takes the output aspect (its viewport follows the image size,
    main.cpp:171), the others keep their preset's."""
    if name == "final_scene":
        return build_final_scene(width / height, device=device)
    return PRESETS[name].build(device=device)


def _cmd_info() -> int:
    cuda = torch.cuda.is_available()
    info = {
        "version": __version__,
        "backend": "cuda" if cuda else "cpu",
        "devices": ([f"cuda:{i} {torch.cuda.get_device_name(i)}"
                     for i in range(torch.cuda.device_count())]
                    if cuda else ["cpu"]),
        "native_runtime": False,        # the port writes PNGs in Python
        "presets": {
            name: {"width": p.width, "height": p.height, "spp": p.spp,
                   "depth": p.max_depth}
            for name, p in PRESETS.items()
        },
    }
    print(json.dumps(info, indent=2))
    return 0


def _cmd_render(args) -> int:
    overrides = {k: v for k, v in dict(
        width=args.width, height=args.height, spp=args.spp,
        max_depth=args.max_depth).items() if v is not None}
    cfg = RenderConfig.for_preset(
        args.scene, renderer=args.renderer, seed=args.seed,
        t_min=args.t_min, attenuate_emission=args.attenuate_emission,
        out=args.out, ppm=args.ppm, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        profile_dir=args.profile_dir, device=args.device, **overrides)
    dev = resolve_device(cfg.device)
    scene, cam = preset_scene(cfg.scene, cfg.width, cfg.height, dev)
    timer = profiling.PhaseTimer()
    renderer = cfg.renderer
    if renderer == "auto":
        renderer = resolve_auto_renderer(dev)
    common = (scene, cam, cfg.width, cfg.height, cfg.spp, cfg.max_depth,
              cfg.attenuate_emission, cfg.t_min)

    segments = None
    with profiling.trace(cfg.profile_dir):
        # the reference's phase name: summary() finds no "render" phase and
        # so divides by the sum of every phase, the PNG write included
        with timer.phase("compile+render"):
            if cfg.checkpoint_dir:
                # the work queue, whatever --renderer says, as in the
                # reference (`render_checkpointed(renderer="jnp")` is the
                # oracle's chunk loop)
                img = render_checkpointed(
                    *common, cfg.seed, cfg.checkpoint_dir,
                    cfg.checkpoint_every, scene_name=cfg.scene, device=dev)
            elif renderer == "wq":
                img, segments, _, _ = render_wq(
                    *common, cfg.seed, return_stats=True, device=dev)
            elif renderer == "wavefront":
                img, segments = render_wavefront(
                    *common, cfg.seed, cfg.tile_pix, cfg.slots,
                    return_segments=True, device=dev)
            elif renderer == "fused":
                img = render_fused(*common, cfg.seed, device=dev)
            elif renderer == "perf":
                img = render_perf(*common, cfg.seed, device=dev)
            else:
                img = render_parity(*common, device=dev)
            img = img.cpu().numpy()         # waits for the device

    samples = cfg.width * cfg.height * cfg.spp
    timer.add_rays(float(segments) if segments is not None else 0.0,
                   samples)
    with timer.phase("write"):
        save_png(cfg.out, img)
        if cfg.ppm:
            sys.stdout.write(dump_ppm(img))
    profiling.log.info("wrote %s (%dx%d, %d spp, %s on %s)", cfg.out,
                       cfg.width, cfg.height, cfg.spp, renderer, dev)
    if args.metrics:
        print(json.dumps(timer.summary()))
    return 0


def _cmd_bench(args) -> int:
    """Render the preset twice at its size and depth (a warm-up that also
    builds the kernel, then the timed run) with what `--renderer auto`
    runs on the device, and print one JSON line of traced segments a
    second."""
    dev = resolve_device(args.device)
    name = args.scene
    p = PRESETS[name]
    spp = args.spp or (2 if dev.type == "cpu" else 40)
    scene, cam = p.build(device=dev)
    renderer = resolve_auto_renderer(dev)

    def run() -> float:
        if renderer == "wavefront":
            segs = render_wavefront(scene, cam, p.width, p.height, spp,
                                    p.max_depth, return_segments=True,
                                    device=dev)[1]
        else:
            segs = render_wq(scene, cam, p.width, p.height, spp,
                             p.max_depth, return_stats=True, device=dev)[1]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return segs

    run()
    t0 = time.perf_counter()
    segs = run()
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": f"forward Mray/s ({name})",
        "value": round(segs / dt / 1e6, 3),
        "unit": "Mray/s",
        "vs_baseline": round(segs / dt / 1e6 / 200.0, 4),
        "backend": dev.type,
        "renderer": renderer,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }))
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "info":
        return _cmd_info()
    if args.cmd == "render":
        return _cmd_render(args)
    return _cmd_bench(args)


if __name__ == "__main__":
    raise SystemExit(main())
