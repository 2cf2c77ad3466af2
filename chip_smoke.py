#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA GPU

Phases, each of which raises on failure (exit code != 0):
1. device: CUDA must be available; prints the GPU name and power limit;
2. build: compiles every kernel from path_tracer_tpu_torch/ops/csrc with
   nvcc, one process per source, all at once (ptxas register report);
3. kernel against plain: one `wave_bounce` call through the CUDA kernel
   and through its plain PyTorch version, both on the card, on a final-
   scene state at full width (800x600: 483,328 lanes) a few bounces in,
   with stalls and pending fixups; prints the agreement and the times;
4. small frame: the final scene at 32x24, 4 spp, depth 8 rendered through
   the kernel (device="cuda") and through the plain version
   (device="cpu"), held to the work-queue test envelope;
5. main path: `render_wq` on the final scene at 800x600, depth 50, 80 spp
   (bench.py's setting), after a short warm-up; prints bench.py's JSON
   fields with "backend": "cuda", checks the kernel's launch count equals
   the bounce iterations, and writes the frame to build/ (git-ignored).
Then the kernel table as one JSON line, the card's name and power limit,
and last {"ok": true, "device": {...}}.  Nothing here imports JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

W, H, DEPTH, SPP = 800, 600, 50, 80
HBM_BYTES_S = 3.35e12     # H100 SXM HBM3 rate (NVIDIA data sheet)
FP32_OPS_S = 67e12        # H100 SXM FP32 peak outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fold_ops_per_lane(tables) -> int:
    """Float ops one advancing lane executes in the intersection folds,
    counted from the kernel source: a static sphere 17 (c-o 3, b 5, c 6,
    disc 3), a moving one 25 (+ center at time 8), a rect 27, a triangle
    40, each medium 60."""
    segs = tables.sph_segs.tolist()
    n_static = n_moving = start = 0
    for static_end, end in segs:
        n_static += static_end - start
        n_moving += end - static_end
        start = end
    return (17 * n_static + 25 * n_moving + 27 * tables.rect.shape[1]
            + 40 * tables.tri.shape[1] + 60 * tables.med.shape[1])


def main() -> dict:
    # ---- 1. device -----------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[1] device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    from path_tracer_tpu_torch.engine.wq import _pack_atlas_flat, render_wq
    from path_tracer_tpu_torch.ops import build, probe
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    from path_tracer_tpu_torch.scene.presets import build_final_scene
    from path_tracer_tpu_torch.utils.image import save_png

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    took = build.build_all()
    log(f"[2] build: {json.dumps(took)} in "
        f"{time.perf_counter() - t0:.1f} s wall")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    # ---- 3. kernel against plain at full width ---------------------------
    scene, cam = build_final_scene(W / H, device=dev)
    tables = WB.pack_scene(scene)._replace(
        cam=WB.pack_camera(cam, W, H, dev), seed=0)
    atlas, _ = _pack_atlas_flat(scene.textures.atlas)
    rows = -(-W * H // (64 * 128)) * 64            # render_wq's lane count
    st, fix, texel, srv = probe.probe_state(
        tables, cam, W, H, atlas, rows=rows, bounces=3, max_depth=DEPTH,
        seed=1, tile_rows=64)
    kw = dict(t_min=1e-3, max_depth=DEPTH, attenuate=False)
    kern = WB.wave_bounce(tables, st, fix, texel, srv, tile_rows=64, **kw)
    torch.cuda.synchronize()
    plain = WB.wave_bounce_plain(tables, st, fix, texel, srv, **kw)
    agree = probe.agreement(kern, plain)
    log(f"[3] kernel vs plain, {rows * 128} lanes: {json.dumps(agree)}")
    bad = [k for k in probe.INT_PLANES if agree[k] < 0.995]
    bad += [k for k in probe.FLOAT_PLANES + probe.FIX_PLANES
            if agree[k] < 0.999]
    if bad:
        raise AssertionError(f"kernel disagrees with plain on {bad}")
    pk, pp = probe.planes(kern), probe.planes(plain)
    same = pk["win"] == pp["win"]
    max_abs = max(float((pk[k][same].double() - pp[k][same].double())
                        .abs().max()) for k in probe.FLOAT_PLANES)
    n_adv = int(((st.alive > 0) & ~((fix.kind != 0) & (srv <= 0))).sum())
    lanes = rows * 128
    nbytes = lanes * (4 * (len(WB.F_RW) + len(WB.F_RO) + 5 + 2) + 8
                      + 4 * (len(WB.F_RW) + 5 + 2) + 8)
    ops = n_adv * fold_ops_per_lane(tables)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    ms = cuda_ms(lambda: WB.wave_bounce(tables, st, fix, texel, srv,
                                        tile_rows=64, **kw), 20)
    plain_ms = cuda_ms(lambda: WB.wave_bounce_plain(tables, st, fix, texel,
                                                    srv, **kw), 2)
    log(f"[3] kernel {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms (bytes {nbytes} -> {t_bytes:.4f} ms, "
        f"fold ops {ops} on {n_adv} advancing lanes -> {t_ops:.4f} ms)")
    kernel_row = dict(
        name="wave_bounce", route="cuda",
        source="path_tracer_tpu_torch/ops/csrc/wave_bounce.cu",
        replaces="path_tracer_tpu/ops/pallas/wave_bounce.py:536",
        launches=0, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None)
    del st, fix, texel, srv, kern, plain, pk, pp

    # ---- 4. small frame: kernel against plain ------------------------------
    small = {}
    for d in ("cuda", "cpu"):
        s_scene, s_cam = build_final_scene(32 / 24, device=d)
        img, segs, iters, _ = render_wq(s_scene, s_cam, 32, 24, 4,
                                        max_depth=8, tile_rows=8, window=3,
                                        return_stats=True, device=d)
        small[d] = (img.cpu().numpy(), segs, iters)
    diff = np.abs(small["cuda"][0] - small["cpu"][0]).max(-1)
    frac = float((diff > 5e-3).mean())
    log(f"[4] small frame 32x24x4: pixels beyond 5e-3 {frac:.4f}, max "
        f"{float(diff.max()):.3g}, segments cuda {small['cuda'][1]} cpu "
        f"{small['cpu'][1]}, iters {small['cuda'][2]} / {small['cpu'][2]}")
    if not (np.isfinite(small["cuda"][0]).all() and frac <= 0.03
            and abs(small["cuda"][1] - small["cpu"][1])
            <= 0.002 * small["cpu"][1]
            and small["cuda"][2] == small["cpu"][2]):
        raise AssertionError("small frame outside the work-queue envelope")

    # ---- 5. main path ----------------------------------------------------
    render_wq(scene, cam, W, H, 2, max_depth=DEPTH, device=dev)   # warm-up
    torch.cuda.synchronize()
    WB.wave_bounce.launches = 0
    WB.wave_bounce.events = []
    t0 = time.perf_counter()
    img, segs, iters, lane_steps = render_wq(
        scene, cam, W, H, SPP, max_depth=DEPTH, return_stats=True,
        device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, events = WB.wave_bounce.launches, WB.wave_bounce.events
    WB.wave_bounce.events = None
    kern_ms = sum(s.elapsed_time(e) for s, e in events)
    samples = W * H * SPP
    mray_s = segs / dt / 1e6
    log(json.dumps({
        "metric": "forward Mray/s/chip (traced segments), final scene "
                  "800x600 depth50",
        "value": round(mray_s, 3), "unit": "Mray/s",
        "vs_baseline": round(mray_s / 200.0, 4),
        "camera_mray_s": round(samples / dt / 1e6, 3),
        "avg_path_len": round(segs / samples, 3),
        "occupancy": round(segs / lane_steps, 3),
        "wq_iters": iters, "backend": "cuda"}))
    log(f"[5] {SPP} spp in {dt:.3f} s; wave_bounce launches {launches} "
        f"(wq_iters {iters}); kernel time {kern_ms:.1f} ms total, "
        f"{kern_ms / max(launches, 1):.4f} ms/launch "
        f"({100 * kern_ms / 1e3 / dt:.1f}% of wall)")
    if launches != iters or launches == 0:
        raise AssertionError(f"launches {launches} != wq_iters {iters}")
    frame = img.cpu().numpy()
    if frame.shape != (H, W, 3) or not np.isfinite(frame).all():
        raise AssertionError("the main-path frame is not finite (H, W, 3)")
    os.makedirs("build", exist_ok=True)
    save_png(os.path.join("build", "chip_smoke_final.png"), frame)
    kernel_row["launches"] = launches
    log(f"    frame mean {float(frame.mean()):.4f}; written to "
        f"build/chip_smoke_final.png")
    return kernel_row


if __name__ == "__main__":
    row = main()
    print(json.dumps({"kernels": [row]}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
