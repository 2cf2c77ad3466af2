#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA GPU
    python3 chip_smoke.py --old-kernel OLD/wave_bounce.cu
        # also times an earlier K1 source (same C interface) beside the
        # current one in phase 10
    python3 chip_smoke.py --old-pmat OLD/spike_pmat.cu
        # also times an earlier K2 source whose launch takes no K
        # beside the current one in phase 6

Phases, each of which raises on failure (exit code != 0):
1. device: CUDA must be available; prints the GPU name and power limit;
2. build: compiles every kernel from path_tracer_tpu_torch/ops/csrc with
   nvcc, one process per source, all at once; prints ptxas's registers,
   spills and shared memory for each kernel instantiation (K1's run-time
   media count, for 5 to 23 media, as NMED=run-time), and for each
   K2 instantiation what its SASS holds (instructions, branches, the
   branches on the disc test, the sqrt's reciprocal roots and slow-path
   calls);
3. kernel against plain: one `wave_bounce` call through the CUDA kernel
   and through its plain PyTorch version, both on the card, on a final-
   scene state at full width (800x600: 483,328 lanes) a few bounces in,
   with stalls and pending fixups; prints the agreement, the times and
   K1's resident blocks an SM for each instantiation (1-4 media and 6
   through the run-time count); then the final scene with 6 media
   (`probe.media_scene`: the run-time media count) and with 4 (the
   templated one), one full-width launch each, bit-equal to the plain
   version on every plane, timed beside its bound; then past the shared-
   memory caps, K1's global variant: the final scene with 30 media and
   with 13,000 static spheres (`probe.sphere_scene`, a fold table over
   208 KB), one launch at 16,384 lanes and one at full width each,
   bit-equal to the plain version and timed, and `render_wq` of each at
   160x120, 2 spp, depth 8 with every launch held bit-equal to the plain
   version (launches = iterations);
4. small frame: the final scene at 32x24, 4 spp, depth 8 rendered through
   the kernel (device="cuda") and through the plain version
   (device="cpu"), held to the work-queue test envelope;
5. main path: `render_wq` on the final scene at 800x600, depth 50, 80 spp
   (bench.py's setting), after a short warm-up; prints bench.py's JSON
   fields with "backend": "cuda", checks the kernel's launch count equals
   the bounce iterations, prints the CUDA events around each launch
   grouped by lane count, renders the frame again on the eager driver
   (`eager_driver`) and holds the replayed frame bit-equal to it, with
   the same launches and lanes, renders it once more with the refill's
   plain version `engine.wq.refill_plain` in the refill kernel's place and
   holds that bit-equal too (the replayed frame's refill launches
   printed), checks the texel kernel's launches are two a bounce and
   renders it once more with the texel service's plain version
   `engine.wq.texel_plain` in the kernel's place, holding image,
   statistics and the texel counters bit-equal, and writes the frame to
   build/ (git-ignored);
6. the nearest-sphere spike (K2) at the reference tool's three calls,
   64, 1024 and 4096 rows of 128 rays (P = 512): at each, the plain
   version's time, the kernel forced to every K (bit-equal to the plain
   version on t and meta, and timed), then in turns the kernel at the
   wrapper's K, the earlier kernel given by --old-pmat and the
   kernel again; the ops the inputs need (`spike_pmat.work`) beside
   every op charged to every pair, and the bound from each; then
   its entry point `run` at each size, the launch count read around it;
7. gradient route, small: the final scene at 32x24, 2 spp, depth 8,
   recorded and differentiated with device="cuda" (the kernel) and
   device="cpu" (the plain version): records equal, per-leaf gradients
   within 2e-3 relative L2 (the order of the replay's gradient sums
   differs between the two devices; its rounding is pinned, `core.vec.
   frsqrt`), and two gradient calls on the card compared;
8. gradient route at full width: tools/bench_grad.py's measurement (the
   final scene at 400x300, 4 spp, depth 50): `ok`, the kernel's launches
   equal to the recorded steps, then a second recording in which every
   launch (stage A at 128 rows, stage B at 8) is held to phase 3's
   criteria against the plain version on its own inputs, and bench_grad's
   JSON fields with "backend": "cuda", "route": "queued_vjp";
9. train steps: 3 SGD steps (lr 0.05) of `make_train_step` at the same
   size from a +0.2 material-colour perturbation, the target recorded at
   the true params; the losses must be finite and fall, and the kernel's
   launches over the three steps equal three times the recorded steps;
10. K1 at every width the paths use: probe states at 3,776 rows (phase
   3's) and at the forward drain stages' 896, 192 and 64 rows, and the
   inputs of one stage-A (128 rows) and one stage-B (8 rows) launch of
   phase 8's checked recording.  At each width: the plain version's
   time, then the kernel forced to each K (bit-equal to the plain
   version on every plane, and timed), then in turns the kernel at the
   wrapper's K, the earlier kernel given by --old-kernel, and the kernel
   again; the wrapper's K is held to phase 3's criteria;
11. app surface, through the command line `path_tracer_tpu_torch.cli`:
   `info` (backend cuda, one device); each of the five presets at 32x24,
   4 spp, depth 8, rendered by `render_wq` (what the CLI calls) through
   the kernel and through the plain version, the frames equal (the kernel
   is bit-equal to its plain version by design), segments and iterations
   equal, K1's launches equal to the iterations; each preset at its own
   size and depth, 8 spp, through `render --device cuda --metrics`, the
   PNG decoded to the preset's shape, beside one `render_wq` of the same
   frame, and the fifth full-width launch of that render kept and held
   bit-equal to the plain version on every plane (each preset's own lane
   count and K; times and bound); the final scene at 800x600, depth 50,
   through `--checkpoint-dir`: 8 spp in ranges of 4, resumed to 16, and a fresh
   16, the two accumulators bit-equal and their mean within 2e-4 of
   `render_wq` at 16 spp (wall, save and load times); `bench` at its
   defaults; `--profile-dir` on three_spheres, whose Chrome trace must
   name K1 among its kernels (the top 10 kernels by device time, host
   ops a bounce, `device_memory_stats()`);
12. multi-device (`parallel/`): (a) world size 1 on NCCL, phase 5's frame
   (800x600, depth 50, 80 spp) through `render_sharded` on a 1x1 mesh
   and `assemble_image`, bit-equal to phase 5's `render_wq`, its Mray/s,
   and its fifth full-width launch held bit-equal to the plain version;
   (b) two ranks on this one card over gloo (NCCL refuses two ranks on
   one GPU), started by `parallel.launch.spawn`, the final scene at
   800x600, depth 50, 8 spp on a (2x1) and a (1x2) mesh, each assembled
   frame within rtol 1e-5, atol 1e-6 of one `render_wq`; each rank's wall
   time, K1's launches (= its iterations) and the collectives' time;
   (c) in the same ranks, one train step on a (2x1) mesh at phase 9's
   setting and perturbation: its loss within 1e-5 relative of phase 9's
   first step, each updated param leaf within 1e-5 relative L2, the
   two ranks' params bit-equal, and each rank's K1 launches equal to the
   recorded steps of its half of the pixels; (d)
   `dryrun.dryrun_multichip(2)` on the card (gloo);
13. the oracle engines (torch ops, no hand kernel) on the card: (a)
   `render_wavefront` of the final scene at 800x600, depth 50, 8 spp
   (one tile of the whole frame) inside tests/test_wq.py's final-scene
   envelope of `render_wq`'s (wall, segments, iterations, lanes, peak
   memory); (b) `render_parity` at 800x600, 1 spp, banded equal to
   unbanded (the peak memory of each), and at 40x24 on the card against
   the CPU (differing pixels counted, held to the envelope if any); (c)
   `render_fused` and `render_perf` of cornell_box at its size, 8 spp,
   depth 8 (cut from its 50), inside the envelope of
   `render_wavefront`; (f) `render_sharded(renderer="jnp")` of that frame
   at world size 1 over NCCL within rtol 1e-5, atol 1e-6 of
   `render_perf`; (d) the CLI's `--renderer parity|wavefront|fused|perf`
   on three_spheres, and `render_checkpointed(renderer="jnp")` resumed
   bit-equal to a fresh render; (e) `checked_render` of cornell_box at
   32x32 and a NaN scene that must raise; (g) two
   `make_train_step(backend="jnp", geometry_edge=[i])` steps at phase 9's
   setting (the metal sphere's silhouette), the loss falling and the
   colour gradient within 2e-2 of a finite difference of the port's own
   render;
14. the one-bounce driver and the pinned gradient route, both through K1:
   (a) `render_wq(window=1)` of the final scene at 32x24, 4 spp, depth 8
   through the kernel and the plain version (frames equal), then at
   800x600, depth 50, 8 spp: wall, Mray/s, iterations = K1's launches,
   the loop's host reads (one a bounce) and the synchronising calls of a
   second run (bit-equal to the first), segments within 0.2% of phase
   11's windowed frame and the frame inside its envelope, the fifth
   launch kept and held bit-equal to the plain version (times, bound);
   (b) `make_render_grad(queued=False)` at phase 8's setting: 50 launches
   at 483,328 lanes, a kept launch, a second recording with every launch
   bit-equal to the plain version, `forward_s`, `value_and_grad_s`, the
   residual bytes and the peak memory; against `make_render_grad(queued=
   True)` on phase 9's perturbed params and target: the forward inside the
   envelope, the loss within 1e-5 relative, each leaf's gradient
   (relative L2; the shutter-time leaves the pinned replay detaches left
   out) printed, and within PINNED_RTOL on the loss over the pixels whose
   paths touch no box (the reference's pinned replay names a box side by
   the scan id all six sides share); (c) `render_grad_fn` on 4,096 seeded
   (pixel, sample) pairs, which `make_render_grad` refuses: the kernel and
   the plain version on the CPU give equal records and radiance, and the
   mean radiance's gradients within 2e-3 relative L2 (phase 7's contract).
Kernel times are CUDA events around 20 launches queued behind a device
sleep, so the launches run back to back and host launch latency is not
in them.  Then the kernel table as one JSON line: K1 once for the forward
path (phase 5's launches, the full-width time) and once for the gradient
route (phase 8's launches, phase 9's as `launches_train`, the stage
times weighted by the stages' launches), each with its per-width times,
K2 (the three `run` calls' launches, the 4096-row times, its
per-size times), and K1 on the app path (phase 11's checkpointed
launches, the largest difference of its frames and kept launches, the
final scene's kept launch's times, each preset's under "presets"), K1
on the sharded path (phase 12's launches in (a)-(c), its kept launch's
times and difference, and the (b) frames' largest difference from
`render_wq` as "frame_err"), and K1's global variant (phase 3's
`render_wq` launches past the caps, the 30-media full-width launch's
times, every case under "cases"); K1's forward row also holds phase 3's 4-
and 6-media launches under "media", and phase 14's launches of the
one-bounce driver and the pinned route ("launches_one_bounce",
"launches_pinned") with their kept launches' times and bounds
("one_bounce", "pinned"); the card's name and power limit; and last
{"ok": true, "device": {...}}.  Nothing here imports JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

W, H, DEPTH, SPP = 800, 600, 50, 80
GW, GH, GSPP = 400, 300, 4        # tools/bench_grad.py's gradient setting
TRAIN_LR = 0.05                   # the reference's default SGD rate
PMAT_ROWS = (64, 1024, 4096)      # tools/spike_pmat.py's run() calls
DRAIN_ROWS = (896, 192, 64)       # render_wq's drain stages at 800x600
APP_SPP, CKPT_EVERY = 8, 4        # phase 11: the CLI renders, checkpoints
KEPT_LAUNCH = 5   # phase 11 keeps this full-width launch of a render
MEDIA_OCC = (1, 2, 3, 4, 6)       # phase 3: K1's occupancy at these counts
SHARD_SPP = 8                     # phase 12 (b): the two-rank frames
CAPS_FRAME = (160, 120, 2, 8)     # phase 3: render_wq past the caps
HBM_BYTES_S = 3.35e12     # H100 SXM HBM3 rate (NVIDIA data sheet)
FP32_OPS_S = 67e12        # H100 SXM FP32 peak outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events.  The
    calls are queued behind a device sleep (~0.5 ms a call) so that the
    host's launch overhead is hidden and the kernels run back to back."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1_000_000 * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_report(text: str) -> list:
    """(kernel, registers, stack frame bytes, spill stores, spill loads,
    static shared bytes) for each entry function in nvcc's -Xptxas -v
    output."""
    rows, fn = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = dict(name=m.group(1), stack=0, spill_st=0, spill_ld=0)
            rows.append(fn)
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and fn is not None:
            fn["stack"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            fn["spill_st"], fn["spill_ld"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            fn["smem"] = int(sm.group(1)) if sm else 0
    for r in rows:
        r["name"] = kernel_name(r["name"])
    return rows


def kernel_name(mangled: str) -> str:
    """A kernel instantiation's name with its template arguments."""
    k = re.search(r"wave_kernelILi(n?\d+)ELi(\d+)E", mangled)
    if k:
        nmed = {"0": "run-time", "n1": "global"}.get(k.group(1), k.group(1))
        return f"wave_kernel<NMED={nmed}, K={k.group(2)}>"
    k = re.search(r"pmat_kernelILi(\d+)E", mangled)
    if k:
        return f"pmat_kernel<K={k.group(1)}>"
    return mangled


def sass_report(lib) -> list:
    """(kernel, instructions, branches, branches on a float test against
    zero, MUFU.RSQ, CALL) for each function in a built library's SASS
    (cuobjdump), or [] without cuobjdump.  A branch on the disc test is
    an `FSETP.GT ... RZ` whose predicate a later `@!P BRA` reads before
    anything writes it again."""
    from path_tracer_tpu_torch.ops import build
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return []
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    rows = []
    for part in text.split("Function : ")[1:]:
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", part)
        disc = 0
        for j, x in enumerate(ins):
            m = re.match(r"FSETP\.GT\.AND (P\d), PT, R\d+, RZ, PT", x)
            for y in ins[j + 1:] if m else ():
                if y.startswith(f"@!{m.group(1)} BRA"):
                    disc += 1
                if re.match(rf"(@!?P\d )?\S+ {m.group(1)},", y):
                    break
        rows.append(dict(
            name=kernel_name(part.split()[0]), instructions=len(ins),
            branches=sum(1 for x in ins if re.search(r"\bBRA\b", x)),
            disc_branches=disc,
            rsq=sum(1 for x in ins if "MUFU.RSQ" in x),
            calls=sum(1 for x in ins if x.startswith("CALL")
                      or " CALL" in x)))
    return rows


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


def k1_compare(kern, plain, what: str):
    """Hold a wave_bounce output to its plain version's on the same
    inputs: every integer plane equal on >= 99.5% of lanes, every float
    and fixup plane within 4 ulp on >= 99.9% of the lanes whose win
    agrees.  Returns (the per-plane agreement, the largest float
    difference on those lanes)."""
    from path_tracer_tpu_torch.ops import probe
    agree = probe.agreement(kern, plain)
    bad = [k for k in probe.INT_PLANES if agree[k] < 0.995]
    bad += [k for k in probe.FLOAT_PLANES + probe.FIX_PLANES
            if agree[k] < 0.999]
    if bad:
        raise AssertionError(f"{what}: kernel disagrees with plain on {bad}: "
                             f"{json.dumps(agree)}")
    pk, pp = probe.planes(kern), probe.planes(plain)
    same = pk["win"] == pp["win"]
    max_abs = max(float((pk[k][same].double() - pp[k][same].double())
                        .abs().max()) if same.any() else 0.0
                  for k in probe.FLOAT_PLANES)
    return agree, max_abs


def k1_bound(tables, st, fix, srv):
    """(bytes, fold ops) one wave_bounce launch must move and do on these
    inputs: each state, fixup and texel plane read once and each output
    written once; the fold ops of the lanes that advance."""
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    lanes = st.ox.numel()
    nbytes = lanes * (4 * (len(WB.F_RW) + len(WB.F_RO) + 5 + 2) + 8
                      + 4 * (len(WB.F_RW) + 5 + 2) + 8)
    n_adv = int(((st.alive > 0) & ~((fix.kind != 0) & (srv <= 0))).sum())
    return nbytes, n_adv * fold_ops_per_lane(tables)


def k1_bits(out):
    """Every plane of a wave_bounce output, floats as their bits."""
    return [x.view(torch.int32) if x.dtype == torch.float32 else x
            for x in (*out.state, *out.fix, out.win, out.t_hit)]


def phase_media(dev) -> dict:
    """3, more media: a full-width K1 launch on the final scene with 6
    media (the kernel's run-time media count) and with 4 (its templated
    instantiation), each a probe state a few bounces in: bit-equal to the
    plain version on every plane, timed, beside its bound."""
    from path_tracer_tpu_torch.engine.wq import _pack_atlas_flat
    from path_tracer_tpu_torch.ops import probe
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    rows = -(-W * H // (64 * 128)) * 64
    kw = dict(t_min=1e-3, max_depth=DEPTH, attenuate=False)
    out = {}
    for n_med in (4, 6):
        scene, cam = probe.media_scene(W / H, n_med, device=dev)
        tables = WB.pack_scene(scene)._replace(
            cam=WB.pack_camera(cam, W, H, dev))
        atlas, _ = _pack_atlas_flat(scene.textures.atlas)
        st, fix, texel, srv = probe.probe_state(
            tables, cam, W, H, atlas, rows=rows, bounces=3, max_depth=DEPTH,
            seed=1, tile_rows=64)
        call = lambda: WB.wave_bounce(tables, st, fix, texel, srv,
                                      tile_rows=64, **kw)
        plain = WB.wave_bounce_plain(tables, st, fix, texel, srv, **kw)
        kern = call()
        if not all(torch.equal(x, y) for x, y in zip(k1_bits(kern),
                                                     k1_bits(plain))):
            raise AssertionError(f"{n_med} media: the kernel is not "
                                 f"bit-equal to the plain version")
        _, max_abs = k1_compare(kern, plain, f"{n_med} media")
        ms = cuda_ms(call, 20)
        plain_ms = cuda_ms(lambda: WB.wave_bounce_plain(
            tables, st, fix, texel, srv, **kw), 2)
        nbytes, ops = k1_bound(tables, st, fix, srv)
        t_b, t_o = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
        win = kern.win
        cls = torch.remainder(torch.div(win - 1, 1024,
                                        rounding_mode="floor"), 4)
        media_wins = int(((win > 0) & (cls == 3)).sum())
        out[n_med] = dict(lanes=st.ox.numel(), K=WB.split_for(st.ox.numel()),
                          ms=ms, plain_ms=plain_ms, bound_ms=max(t_b, t_o),
                          bound_by="bytes" if t_b >= t_o else "operations",
                          max_abs_err=max_abs, media_wins=media_wins)
        log(f"[3] {n_med} media ({'run-time' if n_med > 4 else 'templated'}"
            f" count), {st.ox.numel()} lanes (K={out[n_med]['K']}): "
            f"bit-equal to plain on every plane, {media_wins} lanes end in "
            f"a medium; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{max(t_b, t_o):.5f} ms ({out[n_med]['bound_by']})")
        del st, fix, texel, srv, kern, plain
    return out


class eager_driver:
    """Within the block the windowed driver runs every window eagerly: a
    hook on K1's `_launch` sees only the launches Python makes, and a
    window replayed as a CUDA graph makes none."""

    def __enter__(self):
        from path_tracer_tpu_torch.engine import wq
        self.wq, self.replays = wq, wq._replays
        wq._replays = lambda dev: False
        return self

    def __exit__(self, *exc):
        self.wq._replays = self.replays


def check_every_launch(what: str):
    """A context in which every K1 launch is held bit-equal to the plain
    version on its own inputs, on every plane; `.n` counts them and
    `.max_abs` is the largest float difference (0 when bit-equal).  The
    windowed driver's windows run eagerly there (`eager_driver`)."""
    from path_tracer_tpu_torch.ops import wave_bounce as WB

    class Checked:
        n, max_abs = 0, 0.0

        def __enter__(self):
            self.eager = eager_driver().__enter__()
            self.launch = launch = WB._launch

            def checked(tables, st, fix, texel, srv, t_min, max_depth,
                        attenuate, split=None):
                outs = launch(tables, st, fix, texel, srv, t_min, max_depth,
                              attenuate, split)
                kern = WB._wave_out(st, outs)
                plain = WB.wave_bounce_plain(tables, st, fix, texel, srv,
                                             t_min=t_min,
                                             max_depth=max_depth,
                                             attenuate=attenuate)
                if not all(torch.equal(x, y) for x, y in zip(
                        k1_bits(kern), k1_bits(plain))):
                    raise AssertionError(f"{what}: launch {self.n} is not "
                                         f"bit-equal to the plain version")
                self.max_abs = max(self.max_abs,
                                   k1_compare(kern, plain, what)[1])
                self.n += 1
                return outs

            WB._launch = checked
            return self

        def __exit__(self, *exc):
            WB._launch = self.launch
            self.eager.__exit__(*exc)

    return Checked()


def phase_caps(dev) -> dict:
    """3, past the shared-memory caps: the final scene with 30 media
    (`probe.media_scene`) and with 13,000 static spheres
    (`probe.sphere_scene`, a fold table over 208 KB), both K1's global
    variant.  For each: one launch at 16,384 lanes and one at full width
    on a probe state, bit-equal to the plain version on every plane and
    timed beside the bound; then `render_wq` of the scene at CAPS_FRAME
    with every launch held bit-equal to the plain version, its launches
    counted from 0.  Returns the kernels-line row of the variant."""
    from path_tracer_tpu_torch.engine.wq import _pack_atlas_flat, render_wq
    from path_tracer_tpu_torch.ops import probe
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    kw = dict(t_min=1e-3, max_depth=DEPTH, attenuate=False)
    full_rows = -(-W * H // (64 * 128)) * 64
    cases, launches, max_abs = {}, 0, 0.0
    for name, build in (
            ("30 media", lambda: probe.media_scene(W / H, 30, device=dev)),
            ("13,000 spheres", lambda: probe.sphere_scene(W / H,
                                                          device=dev))):
        scene, cam = build()
        tables = WB.pack_scene(scene)._replace(
            cam=WB.pack_camera(cam, W, H, dev))
        variant = WB.k1_variant(tables.med.shape[1],
                                tables.fold.shape[0] * 16)
        if variant != "global":
            raise AssertionError(f"{name}: takes the {variant} variant")
        atlas, _ = _pack_atlas_flat(scene.textures.atlas)
        for rows in (128, full_rows):
            st, fix, texel, srv = probe.probe_state(
                tables, cam, W, H, atlas, rows=rows, bounces=3,
                max_depth=DEPTH, seed=1, tile_rows=64)
            call = lambda: WB.wave_bounce(tables, st, fix, texel, srv,
                                          tile_rows=64, **kw)
            plain = WB.wave_bounce_plain(tables, st, fix, texel, srv, **kw)
            kern = call()
            if not all(torch.equal(x, y) for x, y in zip(k1_bits(kern),
                                                         k1_bits(plain))):
                raise AssertionError(f"{name}, {rows * 128} lanes: the "
                                     f"kernel is not bit-equal to plain")
            _, err = k1_compare(kern, plain, name)
            max_abs = max(max_abs, err)
            ms = cuda_ms(call, 10)
            plain_ms = cuda_ms(lambda: WB.wave_bounce_plain(
                tables, st, fix, texel, srv, **kw), 1)
            nbytes, ops = k1_bound(tables, st, fix, srv)
            t_b, t_o = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
            cases[f"{name}, {rows * 128} lanes"] = dict(
                lanes=rows * 128, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                max_abs_err=err, fold_bytes=tables.fold.shape[0] * 16,
                media=tables.med.shape[1])
            log(f"[3] {name} (global variant, fold table "
                f"{tables.fold.shape[0] * 16} B, {tables.med.shape[1]} "
                f"media), {rows * 128} lanes (K=1): bit-equal to plain on "
                f"every plane; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                f"bound {max(t_b, t_o):.5f} ms")
            del st, fix, texel, srv, kern, plain
        cw, ch, cspp, cdepth = CAPS_FRAME
        WB.wave_bounce.launches = 0
        with check_every_launch(f"render_wq, {name}") as chk:
            img, segs, iters, _ = render_wq(scene, cam, cw, ch, cspp,
                                            max_depth=cdepth,
                                            return_stats=True, device=dev)
        n = WB.wave_bounce.launches
        frame = img.cpu().numpy()
        log(f"[3] render_wq, {name}, {cw}x{ch}x{cspp} depth {cdepth}: "
            f"{n} launches (iterations {iters}), each bit-equal to plain; "
            f"frame mean {float(frame.mean()):.4f}")
        if n == 0 or n != iters or chk.n != n or not np.isfinite(
                frame).all():
            raise AssertionError(f"render_wq on {name}: launches {n}, "
                                 f"iterations {iters}, checked {chk.n}")
        launches += n
        max_abs = max(max_abs, chk.max_abs)
    big = cases[f"30 media, {full_rows * 128} lanes"]
    return dict(name="wave_bounce", path="global variant", route="cuda",
                source="path_tracer_tpu_torch/ops/csrc/wave_bounce.cu",
                replaces="path_tracer_tpu/ops/pallas/wave_bounce.py:536",
                launches=launches, max_abs_err=max_abs, ms=big["ms"],
                plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
                bound_by=big["bound_by"], library_ms=None, cases=cases)


def time_host(fn, reps: int) -> float:
    """Mean wall seconds of fn() ending in a device synchronise, after
    one warm-up call (the reference's bench_grad timing)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def main(old_kernel=None, old_pmat=None) -> list:
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

    from path_tracer_tpu_torch.engine import wq
    from path_tracer_tpu_torch.engine.wq import _pack_atlas_flat, render_wq
    from path_tracer_tpu_torch.ops import build, probe
    from path_tracer_tpu_torch.ops import refill as RF
    from path_tracer_tpu_torch.ops import texel as TX
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    from path_tracer_tpu_torch.scene.presets import build_final_scene
    from path_tracer_tpu_torch.utils.image import save_png

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    took = build.build_all()
    log(f"[2] build: {json.dumps(took)} in "
        f"{time.perf_counter() - t0:.1f} s wall")
    for name, text in build.build_log.items():
        for r in ptxas_report(text):
            log(f"    {name}: {r['name']}: {r.get('regs')} registers, stack "
                f"frame {r['stack']} B, spill "
                f"stores {r['spill_st']} B, loads {r['spill_ld']} B, "
                f"{r.get('smem')} B static shared memory")
    for r in sass_report(build.lib_path("spike_pmat")):
        log(f"    spike_pmat SASS: {r['name']}: {r['instructions']} "
            f"instructions, {r['branches']} branches of which "
            f"{r['disc_branches']} on the disc test, {r['rsq']} MUFU.RSQ, "
            f"{r['calls']} calls (the sqrt's slow path)")

    # ---- 3. kernel against plain at full width ---------------------------
    scene, cam = build_final_scene(W / H, device=dev)
    tables = WB.pack_scene(scene)._replace(
        cam=WB.pack_camera(cam, W, H, dev))
    atlas, _ = _pack_atlas_flat(scene.textures.atlas)
    rows = -(-W * H // (64 * 128)) * 64            # render_wq's lane count
    st, fix, texel, srv = probe.probe_state(
        tables, cam, W, H, atlas, rows=rows, bounces=3, max_depth=DEPTH,
        seed=1, tile_rows=64)
    kw = dict(t_min=1e-3, max_depth=DEPTH, attenuate=False)
    kern = WB.wave_bounce(tables, st, fix, texel, srv, tile_rows=64, **kw)
    torch.cuda.synchronize()
    plain = WB.wave_bounce_plain(tables, st, fix, texel, srv, **kw)
    agree, max_abs = k1_compare(kern, plain, "probe state")
    log(f"[3] kernel vs plain, {rows * 128} lanes: {json.dumps(agree)}")
    nbytes, ops = k1_bound(tables, st, fix, srv)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    ms = cuda_ms(lambda: WB.wave_bounce(tables, st, fix, texel, srv,
                                        tile_rows=64, **kw), 20)
    plain_ms = cuda_ms(lambda: WB.wave_bounce_plain(tables, st, fix, texel,
                                                    srv, **kw), 2)
    log(f"[3] kernel {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms (bytes {nbytes} -> {t_bytes:.4f} ms, "
        f"fold ops {ops} -> {t_ops:.4f} ms)")
    occ = {f"n_med={m}": {k: WB.occupancy(m, k, tables.fold.shape[0])
                          for k in WB.SPLITS} for m in MEDIA_OCC}
    log(f"[3] K1 resident blocks an SM, by K, with "
        f"this scene's {tables.fold.shape[0] * 16}-byte fold table: "
        f"{json.dumps(occ)}")
    kernel_row = dict(
        name="wave_bounce", path="forward", route="cuda",
        source="path_tracer_tpu_torch/ops/csrc/wave_bounce.cu",
        replaces="path_tracer_tpu/ops/pallas/wave_bounce.py:536",
        launches=0, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None)
    del st, fix, texel, srv, kern, plain
    kernel_row["media"] = phase_media(dev)
    caps_row = phase_caps(dev)

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
    refills = RF.refill.launches
    TX.texel.launches = 0
    texel_counts = lambda: tuple(getattr(wq.wq_window_fb, k) for k in
                                 ("texel_pending", "texel_stalled"))
    counts0 = texel_counts()
    t0 = time.perf_counter()
    img, segs, iters, lane_steps = render_wq(
        scene, cam, W, H, SPP, max_depth=DEPTH, return_stats=True,
        device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, events = WB.wave_bounce.launches, WB.wave_bounce.events
    refills = RF.refill.launches - refills
    texels = TX.texel.launches
    counts = tuple(b - a for a, b in zip(counts0, texel_counts()))
    WB.wave_bounce.events = None
    # a replayed window's launches share one pair of events around it
    kern_ms = sum(s.elapsed_time(e) for s, e in
                  dict.fromkeys((s, e) for _, s, e in events))
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
        f"(wq_iters {iters}); texel launches {texels} (two a bounce); "
        f"time inside K1's events {kern_ms:.1f} ms "
        f"total, {kern_ms / max(launches, 1):.4f} ms/launch "
        f"({100 * kern_ms / 1e3 / dt:.1f}% of wall; a replayed window's "
        f"events span the whole window)")
    if launches != iters or launches == 0:
        raise AssertionError(f"launches {launches} != wq_iters {iters}")
    if texels != 2 * iters:
        raise AssertionError(f"texel launches {texels} != 2 x wq_iters "
                             f"{iters}")
    by_width, seen = {}, set()
    for lanes, s, e in events:
        n, ms_ = by_width.get(lanes, (0, 0.0))
        by_width[lanes] = (n + 1, ms_ + (0.0 if (s, e) in seen
                                        else s.elapsed_time(e)))
        seen.add((s, e))
    log("[5] events around each launch, by lane count: " + "; ".join(
        f"{lanes} lanes (K={WB.split_for(lanes)}): {n} launches, "
        f"{ms_:.1f} ms, {ms_ / n:.4f} ms each"
        for lanes, (n, ms_) in sorted(by_width.items(), reverse=True)))
    kernel_row["launches"] = launches
    # the same frame on the eager driver, whose launches the hooks of the
    # other phases hold bit-equal: the replayed frame must give its bits
    WB.wave_bounce.launches = 0
    WB.wave_bounce.events = []
    with eager_driver():
        e_img, e_segs, e_iters, _ = render_wq(
            scene, cam, W, H, SPP, max_depth=DEPTH, return_stats=True,
            device=dev)
    torch.cuda.synchronize()
    e_launches, e_events = WB.wave_bounce.launches, WB.wave_bounce.events
    WB.wave_bounce.events = None
    lanes_of = lambda evs: sorted(n for n, _, _ in evs)
    same = (torch.equal(img.view(torch.int32), e_img.view(torch.int32))
            and (segs, iters) == (e_segs, e_iters)
            and e_launches == launches
            and lanes_of(e_events) == lanes_of(events))
    log(f"[5] the frame again on the eager driver: bit-equal {same}, "
        f"launches {e_launches}, lanes {sum(lanes_of(e_events))} "
        f"(replayed: {sum(lanes_of(events))})")
    if not same:
        raise AssertionError("the replayed main-path frame differs from "
                             "the eager driver's")
    del e_img, e_events
    # the refill kernel against its plain version: the frame with
    # `refill_plain` in its place, through graphs of its own
    real, plans = wq.refill_lanes, wq._plans
    wq.refill_lanes, wq._plans = wq.refill_plain, type(plans)()
    try:
        t_img, t_segs, t_iters, _ = render_wq(
            scene, cam, W, H, SPP, max_depth=DEPTH, return_stats=True,
            device=dev)
        torch.cuda.synchronize()
    finally:
        wq.refill_lanes, wq._plans = real, plans
    same = (torch.equal(img.view(torch.int32), t_img.view(torch.int32))
            and (segs, iters) == (t_segs, t_iters))
    log(f"[5] refill kernel: {refills} launches in the replayed frame "
        f"(two a refill bounce); the frame with `refill_plain` in its "
        f"place: bit-equal {same}")
    if not same or refills == 0:
        raise AssertionError("the frame with the refill kernel differs "
                             "from the one with `refill_plain`")
    del t_img
    # the texel kernel against its plain version: the frame with
    # `texel_plain` in its place, through graphs of its own
    real, plans = wq.texel_lanes, wq._plans
    wq.texel_lanes, wq._plans = wq.texel_plain, type(plans)()
    counts0 = texel_counts()
    try:
        t_img, t_segs, t_iters, _ = render_wq(
            scene, cam, W, H, SPP, max_depth=DEPTH, return_stats=True,
            device=dev)
        torch.cuda.synchronize()
    finally:
        wq.texel_lanes, wq._plans = real, plans
    t_counts = tuple(b - a for a, b in zip(counts0, texel_counts()))
    same = (torch.equal(img.view(torch.int32), t_img.view(torch.int32))
            and (segs, iters, counts) == (t_segs, t_iters, t_counts))
    log(f"[5] texel kernel: {texels} launches in the replayed frame; "
        f"(pending, stalled) {counts}; the frame with `texel_plain` in its "
        f"place: {t_counts}, bit-equal {same}")
    if not same or counts[0] == 0:
        raise AssertionError("the frame with the texel kernel differs "
                             "from the one with `texel_plain`")
    del t_img
    frame = img.cpu().numpy()
    if frame.shape != (H, W, 3) or not np.isfinite(frame).all():
        raise AssertionError("the main-path frame is not finite (H, W, 3)")
    os.makedirs("build", exist_ok=True)
    save_png(os.path.join("build", "chip_smoke_final.png"), frame)
    log(f"    frame mean {float(frame.mean()):.4f}; written to "
        f"build/chip_smoke_final.png")
    del scene, cam, img

    pmat_row = phase_pmat(dev, old_pmat)
    phase_grad_small()
    grad_row, stage_cases, stage_launches = phase_grad_full(dev)
    grad_row["launches_train"], train_first = phase_train(dev)
    widths = phase_widths(dev, stage_cases, old_kernel)
    kernel_row["widths"] = widths[:-len(stage_cases)]
    grad_row["widths"] = widths[-len(stage_cases):]
    # the gradient route's time a launch: each stage's, by its launches
    grad_row["ms"] = sum(n * w["ms"] for n, w in zip(
        stage_launches, grad_row["widths"])) / sum(stage_launches)
    app_row, frame8 = phase_app(dev)
    sharded_row = phase_sharded(dev, frame, train_first)
    phase_oracle(dev)
    one = phase_one_bounce(dev, frame8)
    pinned = phase_pinned(dev, train_first)
    kernel_row.update(launches_one_bounce=one["launches"],
                      one_bounce=one["kept"],
                      launches_pinned=pinned["launches"],
                      pinned=pinned["kept"])
    return [kernel_row, grad_row, pmat_row, app_row, sharded_row, caps_row]


def load_old_pmat(path: str):
    """An earlier csrc/spike_pmat.cu whose C launch takes no K (the
    first CUDA version's interface), built with the current flags and
    loaded."""
    from path_tracer_tpu_torch.ops import build
    out = build.BUILD_DIR / "libspike_pmat_old.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), path],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.spike_pmat_launch.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.spike_pmat_launch.restype = ctypes.c_int
    return lib


def phase_pmat(dev, old_pmat=None) -> dict:
    """6. K2 at each of the reference tool's calls: the plain version,
    every K, and in turns the wrapper's K, the earlier kernel (if given)
    and the wrapper's again; then the entry point `run` at each size.
    Returns K2's kernels-line row."""
    from path_tracer_tpu_torch.ops import spike_pmat as SP
    old = load_old_pmat(old_pmat) if old_pmat else None
    widths = []
    for rows in PMAT_ROWS:
        args = SP.make_inputs(rows, seed=0, device=dev)
        pt, pm = SP.spike_pmat_plain(*args)
        n = pt.numel()

        def same(out, what):
            t, meta = out
            bad_t = int((t.view(torch.int32) != pt.view(torch.int32)).sum())
            bad_m = int((meta != pm).sum())
            if bad_t or bad_m:
                raise AssertionError(f"spike_pmat, {rows} rows, {what}: t "
                                     f"differs on {bad_t} rays, meta on "
                                     f"{bad_m}")
            return t

        plain_ms = cuda_ms(lambda: SP.spike_pmat_plain(*args), 2)
        by = {}
        for k in SP.SPLITS:
            same(SP.spike_pmat(*args, _split=k), f"K = {k}")
            by[k] = cuda_ms(lambda: SP.spike_pmat(*args, _split=k), 20)
        call = lambda: SP.spike_pmat(*args)
        t = same(call(), "the wrapper's K")
        fin = torch.isfinite(pt)
        max_abs = float(torch.where(fin, (t - pt).abs(), 0.0).max())
        ms = [cuda_ms(call, 20)]
        old_ms = None
        if old is not None:
            ot, om = torch.empty_like(pt), torch.empty_like(pt)
            ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (*args, ot, om)]

            def old_call():
                err = old.spike_pmat_launch(*ptrs, n, ctypes.c_void_p(
                    torch.cuda.current_stream().cuda_stream))
                if err:
                    raise RuntimeError(f"the earlier spike_pmat: CUDA "
                                       f"error {err}")

            old_call()
            same((ot, om), "the earlier kernel")
            old_ms = cuda_ms(old_call, 20)
        ms.append(cuda_ms(call, 20))
        w = SP.work(*args)
        b = SP.bound_ms(w, FP32_OPS_S, HBM_BYTES_S)
        all_ms = w["ops_all"] / FP32_OPS_S * 1e3
        k = SP.split_for(n)
        row = dict(rows=rows, rays=n, K=k, ms=min(ms), ms_turns=ms,
                   old_ms=old_ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
                   bound_by=b["bound_by"], ops=w["ops"],
                   ops_all=w["ops_all"], disc_pos=w["disc_pos"],
                   keyed=w["keyed"], warps_pos=w["warps_pos"],
                   max_abs_err=max_abs, ms_by_K=by)
        old_txt = "not given" if old_ms is None else (
            f"{old_ms:.4f} ms ({100 * b['bound_ms'] / old_ms:.1f}% of the "
            f"bound)")
        log(f"[6] spike_pmat, {rows} rows ({n} rays): hits "
            f"{float(fin.float().mean()):.4f}; every K bit-equal to the "
            f"plain version on t and meta; ms by K "
            f"{json.dumps({x: round(v, 4) for x, v in by.items()})}")
        log(f"[6] spike_pmat, {rows} rows: K={k} {ms[0]:.4f} / {ms[1]:.4f} "
            f"ms ({100 * b['bound_ms'] / min(ms):.1f}% of "
            f"the bound), earlier kernel {old_txt}, plain {plain_ms:.3f} "
            f"ms; ops the inputs need {w['ops']} ({w['disc_pos']} pairs of "
            f"{w['pairs']} with disc > 0, {w['keyed']} with a key; "
            f"{w['warps_pos']} of {w['warps']} (32-ray warp, sphere) pairs "
            f"with any disc > 0) -> bound "
            f"{b['bound_ms']:.5f} ms, {b['bound_by']} ({b['bytes']} bytes -> "
            f"{b['bytes_ms']:.5f} ms); every op on every pair {w['ops_all']}"
            f" -> {all_ms:.5f} ms")
        widths.append(row)
        del args, pt, pm, t
    launches = 0
    for row in widths:
        SP.spike_pmat.launches = 0
        row["run"] = SP.run(row["rows"], device=dev)
        row["launches"] = SP.spike_pmat.launches
        log(f"[6] run({row['rows']}): {json.dumps(row['run'])}; launches "
            f"{row['launches']}")
        if row["launches"] == 0:
            raise AssertionError(f"run({row['rows']}) launched no "
                                 f"spike_pmat kernel")
        launches += row["launches"]
    wide = widths[-1]
    return dict(name="spike_pmat", route="cuda",
                source="path_tracer_tpu_torch/ops/csrc/spike_pmat.cu",
                replaces="tools/spike_pmat.py:82", launches=launches,
                max_abs_err=max(w["max_abs_err"] for w in widths),
                ms=wide["ms"], plain_ms=wide["plain_ms"],
                bound_ms=wide["bound_ms"], bound_by=wide["bound_by"],
                library_ms=None, widths=widths)


def count_ops(fn) -> int:
    """The aten ops fn() dispatches to PyTorch's kernels (a launch through
    ctypes is not one)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.n


def _grads(f, scene, cam, backward: bool = True):
    """(loss, gradient leaves) of mean(f(scene, cam)) w.r.t. every float
    leaf of (scene, camera); the loss alone without `backward`."""
    from path_tracer_tpu_torch.diff import params as P
    params, static = P.partition((scene, cam))
    xs = [x.detach().requires_grad_(True) for x in P.leaves(params)]
    loss = f(*P.combine(P.with_leaves(params, xs), static)).mean()
    return loss, torch.autograd.grad(loss, xs) if backward else None


def phase_grad_small(devices=("cuda", "cpu")) -> None:
    """7. The gradient route on the kernel and on the plain version, the
    final scene at 32x24, 2 spp, depth 8."""
    from path_tracer_tpu_torch.diff import queued_vjp as Q
    from path_tracer_tpu_torch.scene.presets import build_final_scene
    w, h, spp, depth = 32, 24, 2, 8
    out = {}
    for d in devices:
        scene, cam = build_final_scene(w / h, device=d)
        f = Q.render_grad_fb(w, h, w * h, spp, max_depth=depth, tile_rows=8,
                             device=d)
        loss, g = _grads(f, scene, cam)
        rec, ok = f.last
        out[d] = dict(loss=float(loss.detach()), grads=[x.cpu() for x in g],
                      rec=rec, ok=bool(ok), f=f, scene=scene, cam=cam)
    a, b = (out[d] for d in devices)
    diffs = {}
    for name in ("a", "b"):
        for field in Q.ResQ._fields:
            x = getattr(getattr(a["rec"], name), field).cpu()
            y = getattr(getattr(b["rec"], name), field).cpu()
            diffs[f"{name}.{field}"] = int((x != y).sum())
    for name in ("perm", "pvalid"):
        diffs[name] = int((getattr(a["rec"], name).cpu()
                           != getattr(b["rec"], name).cpu()).sum())
    worst = 0.0
    for x, y in zip(a["grads"], b["grads"]):
        x, y = x.double(), y.double()
        worst = max(worst, float((x - y).norm()) / max(float(y.norm()),
                                                        1e-4))
    _, g2 = _grads(a["f"], a["scene"], a["cam"])
    rerun = max(float((x.cpu() - y).abs().max())
                for x, y in zip(g2, a["grads"]))
    cfg = a["f"].cfg
    steps = (cfg["n_windows"] + cfg["n_windows_b"]) * cfg["window"]
    n_fwd = count_ops(lambda: _grads(a["f"], a["scene"], a["cam"],
                                     backward=False))
    n_all = count_ops(lambda: _grads(a["f"], a["scene"], a["cam"]))
    log(f"[7] host-issued PyTorch ops on {devices[0]}, {steps} steps: "
        f"{n_fwd / steps:.0f} a step in the recording forward, "
        f"{(n_all - n_fwd) / steps:.0f} a step in the backward (replay, "
        f"window recompute and its gradient)")
    log(f"[7] gradient route {w}x{h}x{spp} depth {depth}: ok {a['ok']} / "
        f"{b['ok']}, loss {a['loss']} / {b['loss']}; record entries that "
        f"differ: {json.dumps({k: v for k, v in diffs.items() if v})}; "
        f"worst leaf relative L2 {worst:.3g}; two calls on "
        f"{devices[0]}: largest gradient difference {rerun}")
    if not (a["ok"] and b["ok"]) or any(diffs.values()) or worst > 2e-3:
        raise AssertionError("gradient route: kernel and plain disagree")


def phase_grad_full(dev) -> dict:
    """8. tools/bench_grad.py's measurement on the port; returns K1's
    kernels-line row for the gradient route."""
    from path_tracer_tpu_torch.diff import queued_vjp as Q
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    from path_tracer_tpu_torch.scene.presets import build_final_scene
    w, h, spp, depth = GW, GH, GSPP, DEPTH
    scene, cam = build_final_scene(w / h, device=dev)
    f = Q.render_grad_fb(w, h, w * h, spp, max_depth=depth, device=dev)
    cfg = f.cfg
    rcfg = {k: v for k, v in cfg.items() if k not in ("width", "height")}
    Q.record_forward_q(scene, cam, w, h, 0, 0, **rcfg)        # warm-up
    torch.cuda.synchronize()
    WB.wave_bounce.launches = 0
    WB.wave_bounce.events = []
    t0 = time.perf_counter()
    _, rec, ok = Q.record_forward_q(scene, cam, w, h, 0, 0, **rcfg)
    torch.cuda.synchronize()
    t_rec = time.perf_counter() - t0
    launches, events = WB.wave_bounce.launches, WB.wave_bounce.events
    WB.wave_bounce.events = None
    kern_ms = [s.elapsed_time(e) for _, s, e in events]
    kern_s = sum(kern_ms) / 1e3
    steps = cfg["n_windows"] * cfg["window"]
    steps_b = cfg["n_windows_b"] * cfg["window"]
    segs = float(Q.rec_segments(rec))
    log(f"[8] recorded forward: ok {bool(ok)}, {segs:.0f} segments, "
        f"{launches} launches for {steps} + {steps_b} steps on {cfg['rows']}"
        f" / {cfg['rows_b']} rows; {t_rec:.3f} s, kernel {kern_s:.3f} s "
        f"({100 * kern_s / t_rec:.1f}% of wall)")
    if not bool(ok):
        raise AssertionError("the recording schedule did not finish")
    if launches != steps + steps_b:
        raise AssertionError(f"launches {launches} != recorded steps "
                             f"{steps + steps_b}")
    del rec

    chk = record_checked(scene, cam, w, h, rcfg,
                         keep=(steps // 2, steps + steps_b // 2))
    if chk["n"] != launches:
        raise AssertionError(f"the checked recording launched {chk['n']} "
                             f"times, the counted one {launches}")
    for tag, ks, c in (("A", kern_ms[:steps], chk[cfg["rows"]]),
                       ("B", kern_ms[steps:], chk[cfg["rows_b"]])):
        log(f"[8] stage {tag}: events around each launch {sum(ks) / len(ks):.4f}"
            f" ms (host launch latency included), "
            f"plain {c['plain_ms'] / c['n']:.3f} ms, bound "
            f"{c['bound_ms'] / c['n']:.4f} ms (bytes "
            f"{c['bytes_ms'] / c['n']:.4f} ms, fold ops "
            f"{c['ops_ms'] / c['n']:.4f} ms), mean over {c['n']} launches")
    log(f"[8] every launch held to phase 3's criteria against the plain "
        f"version: largest float difference {chk['max_abs']}")
    row = dict(
        name="wave_bounce", path="gradient", route="cuda",
        source="path_tracer_tpu_torch/ops/csrc/wave_bounce.cu",
        replaces="path_tracer_tpu/ops/pallas/wave_bounce.py:536",
        launches=launches, max_abs_err=chk["max_abs"],
        ms=sum(kern_ms) / launches, plain_ms=chk["plain_ms"] / chk["n"],
        bound_ms=chk["bound_ms"] / chk["n"],
        bound_by="bytes" if chk["bytes_ms"] >= chk["ops_ms"]
        else "operations", library_ms=None)

    def fwd():
        with torch.no_grad():
            f(scene, cam).mean()

    torch.cuda.reset_peak_memory_stats()
    t_fwd = time_host(fwd, 3)
    t_both = time_host(lambda: _grads(f, scene, cam), 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t_bwd = max(t_both - t_fwd, 1e-9)
    log(json.dumps({
        "config": {"width": w, "height": h, "spp": spp, "depth": depth,
                   "scene": "final", "backend": "cuda",
                   "route": "queued_vjp", "rows": cfg["rows"],
                   "steps": steps, "steps_b": steps_b,
                   "rows_b": cfg["rows_b"]},
        "segments": segs, "queue_drained": bool(ok),
        "forward_s": round(t_fwd, 4), "value_and_grad_s": round(t_both, 4),
        "forward_mray_s": round(segs / t_fwd / 1e6, 3),
        "backward_mray_s": round(segs / t_bwd / 1e6, 3),
        "grad_step_mray_s": round(segs / t_both / 1e6, 3)}))
    log(f"[8] peak device memory over forward + value_and_grad "
        f"{peak:.2f} GiB")
    stage_cases = [(f"gradient stage {tag}, launch {n}", chk["kept"][n])
                   for tag, n in zip("AB", sorted(chk["kept"]))]
    return row, stage_cases, (steps, steps_b)


def record_checked(scene, cam, w: int, h: int, rcfg: dict,
                   keep=()) -> dict:
    """One more recording of the same schedule in which every wave_bounce
    launch is held to phase 3's criteria against the plain version on the
    launch's own inputs (state, pending fixups, texels, texel-service
    mask).  Returns the launch count, the largest float difference, per
    stage (keyed by its row count) and in all the summed plain version's
    ms and bounds, and under "kept" a copy of the inputs of the launches
    numbered in `keep`."""
    from path_tracer_tpu_torch.diff import queued_vjp as Q
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    launch = WB._launch
    keys = ("n", "plain_ms", "bytes_ms", "ops_ms", "bound_ms")
    acc = dict(dict.fromkeys(keys, 0), max_abs=0.0, kept={})

    def checked(tables, st, fix, texel, srv, t_min, max_depth, attenuate,
                split=None):
        if acc["n"] in keep:
            acc["kept"][acc["n"]] = (tables, *(
                type(x)(*[t.clone() for t in x]) if isinstance(x, tuple)
                else x.clone() for x in (st, fix, texel, srv)), dict(
                    t_min=t_min, max_depth=max_depth, attenuate=attenuate))
        outs = launch(tables, st, fix, texel, srv, t_min, max_depth,
                      attenuate, split)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        plain = WB.wave_bounce_plain(tables, st, fix, texel, srv,
                                     t_min=t_min, max_depth=max_depth,
                                     attenuate=attenuate)
        end.record()
        end.synchronize()
        _, max_abs = k1_compare(WB._wave_out(st, outs), plain,
                                f"gradient-route launch {acc['n']}")
        nbytes, ops = k1_bound(tables, st, fix, srv)
        t_b, t_o = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
        add = dict(n=1, plain_ms=start.elapsed_time(end), bytes_ms=t_b,
                   ops_ms=t_o, bound_ms=max(t_b, t_o))
        stage = acc.setdefault(st.ox.shape[0], dict.fromkeys(keys, 0))
        for k in keys:
            acc[k] += add[k]
            stage[k] += add[k]
        acc["max_abs"] = max(acc["max_abs"], max_abs)
        return outs

    WB._launch = checked
    try:
        Q.record_forward_q(scene, cam, w, h, 0, 0, **rcfg)
    finally:
        WB._launch = launch
    return acc


def perturb_colors(params):
    """The material colours' x raised by 0.2 (phases 9 and 12)."""
    c = params[0].materials.color
    return (params[0]._replace(materials=params[0].materials._replace(
        color=type(c)(c.x + 0.2, c.y, c.z))), params[1])


def only_material_colors(grads):
    """The gradient tree with every leaf but the material colours
    zeroed."""
    from path_tracer_tpu_torch.diff import params as P
    zs, zc = P.tree_map(lambda g: None if g is None
                        else torch.zeros_like(g), grads)
    return (zs._replace(materials=zs.materials._replace(
        color=grads[0].materials.color)), zc)


def phase_train(dev) -> tuple:
    """9. Three SGD steps on the material colours from a +0.2 perturbation
    toward a target recorded at the true params, at the reference's
    default lr.  A +0.2 glass tint gains energy at every one of up to 50
    dielectric bounces, so a few firefly pixels dominate the first loss
    and its gradient; at tests/test_sharding.py's lr 0.5 (depth 3 there)
    this phase diverged (0.0843 -> 3.83 -> inf on an H100 80GB HBM3 at
    700 W).  Returns the kernel's launches and, for phase 12, the target
    and the first step's loss and params (numpy)."""
    from path_tracer_tpu_torch.diff import params as P
    from path_tracer_tpu_torch.diff import queued_vjp as Q
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    from path_tracer_tpu_torch.parallel.mesh import (make_train_step,
                                                     scene_camera_params)
    from path_tracer_tpu_torch.scene.presets import build_final_scene
    w, h, spp, depth, lr = GW, GH, GSPP, DEPTH, TRAIN_LR
    scene, cam = build_final_scene(w / h, device=dev)
    f = Q.render_grad_fb(w, h, w * h, spp, max_depth=depth, device=dev)
    with torch.no_grad():
        target = f(scene, cam)
    params, (s_scene, s_cam) = scene_camera_params(scene, cam)
    params = perturb_colors(params)
    step = make_train_step(s_scene, s_cam, w, h, spp, depth, lr=lr,
                           grad_filter=only_material_colors, device=dev)
    pix = torch.arange(w * h, device=dev)
    losses = []
    WB.wave_bounce.launches = 0
    t0 = time.perf_counter()
    for i in range(3):
        params, loss = step(params, target, pix)
        losses.append(float(loss))
        if i == 0:
            first = [x.cpu().numpy() for x in P.leaves(params)]
    dt = (time.perf_counter() - t0) / 3
    launches = WB.wave_bounce.launches
    steps = (f.cfg["n_windows"] + f.cfg["n_windows_b"]) * f.cfg["window"]
    log(f"[9] train steps {w}x{h}x{spp} depth {depth}, lr {lr}: losses "
        f"{losses}; {dt:.3f} s a step; wave_bounce launches {launches} "
        f"for 3 x {steps} recorded steps")
    if not (all(np.isfinite(losses)) and losses[0] > losses[1] > losses[2]):
        raise AssertionError(f"the loss did not fall: {losses}")
    if launches != 3 * steps:
        raise AssertionError(f"train steps launched the kernel {launches} "
                             f"times, not 3 x {steps}")
    return launches, dict(target=target.cpu().numpy(), loss=losses[0],
                          params=first)


def forward_cases(dev) -> list:
    """Probe states at the forward path's widths: phase 3's full width
    (the same seed, so the same state) and the drain stages'."""
    from path_tracer_tpu_torch.engine.wq import _pack_atlas_flat
    from path_tracer_tpu_torch.ops import probe
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    from path_tracer_tpu_torch.scene.presets import build_final_scene
    scene, cam = build_final_scene(W / H, device=dev)
    tables = WB.pack_scene(scene)._replace(
        cam=WB.pack_camera(cam, W, H, dev))
    atlas, _ = _pack_atlas_flat(scene.textures.atlas)
    kw = dict(t_min=1e-3, max_depth=DEPTH, attenuate=False)
    rows = -(-W * H // (64 * 128)) * 64
    return [(name, (tables, *probe.probe_state(
        tables, cam, W, H, atlas, rows=r, bounces=3, max_depth=DEPTH,
        seed=seed, tile_rows=64), kw))
        for name, r, seed in [("forward, full width", rows, 1)]
        + [(f"forward drain, {r} rows", r, 2) for r in DRAIN_ROWS]]


def phase_widths(dev, stage_cases, old_kernel) -> list:
    """10. K1 at each width the paths use: the plain version, every K,
    and in turns the wrapper's K, the earlier kernel (if given) and the
    wrapper's K again.  Returns a row a width."""
    from path_tracer_tpu_torch.ops import build
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    cases = forward_cases(dev) + stage_cases
    old = None
    if old_kernel:
        path = build.BUILD_DIR / "libwave_bounce_old.so"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(path),
                        old_kernel], check=True, capture_output=True)
        old = ctypes.CDLL(str(path))
        old.wave_bounce_launch.argtypes = [ctypes.c_void_p] * 2
        old.wave_bounce_launch.restype = ctypes.c_int
        old.wave_bounce_error_string.argtypes = [ctypes.c_int]
        old.wave_bounce_error_string.restype = ctypes.c_char_p
    new_lib = WB._lib

    rows = []
    for name, (tables, st, fix, texel, srv, kw) in cases:
        lanes = st.ox.numel()
        call = lambda **k: WB.wave_bounce(tables, st, fix, texel, srv,
                                          tile_rows=st.ox.shape[0], **kw, **k)
        plain = WB.wave_bounce_plain(tables, st, fix, texel, srv, **kw)
        plain_bits = k1_bits(plain)
        plain_ms = cuda_ms(lambda: WB.wave_bounce_plain(
            tables, st, fix, texel, srv, **kw), 2)
        by_k = {}
        for k in WB.SPLITS:
            if not all(torch.equal(x, y) for x, y in
                       zip(k1_bits(call(_split=k)), plain_bits)):
                raise AssertionError(f"{name}: K={k} is not bit-equal to "
                                     f"the plain version")
            by_k[k] = cuda_ms(lambda: call(_split=k), 20)
        ms = [cuda_ms(call, 20)]
        old_ms = None
        if old is not None:
            WB._lib = lambda: old
            try:
                if not all(torch.equal(x, y) for x, y in
                           zip(k1_bits(call()), plain_bits)):
                    raise AssertionError(f"{name}: the earlier kernel is not "
                                         f"bit-equal to the plain version")
                old_ms = cuda_ms(call, 20)
            finally:
                WB._lib = new_lib
        ms.append(cuda_ms(call, 20))
        _, max_abs = k1_compare(call(), plain, name)
        nbytes, ops = k1_bound(tables, st, fix, srv)
        t_b, t_o = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
        row = dict(what=name, lanes=lanes, K=WB.split_for(lanes),
                   ms=min(ms), ms_turns=ms, old_ms=old_ms, plain_ms=plain_ms,
                   bound_ms=max(t_b, t_o),
                   bound_by="bytes" if t_b >= t_o else "operations",
                   max_abs_err=max_abs, ms_by_K=by_k)
        log(f"[10] {name}, {lanes} lanes: K={row['K']} {ms[0]:.4f} / "
            f"{ms[1]:.4f} ms, earlier kernel "
            f"{'not given' if old_ms is None else f'{old_ms:.4f} ms'}, plain "
            f"{plain_ms:.3f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}); every K bit-equal, ms by K "
            f"{json.dumps({k: round(v, 4) for k, v in by_k.items()})}")
        rows.append(row)
    return rows


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG with unfiltered rows, as the port's writer makes
    it, decoded with the standard library (the card's host
    need not have an image package): (H, W, 3) uint8."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise AssertionError(f"{path}: bad CRC in {tag}")
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)
    if (depth, ctype, interlace) != (8, 2, 0) or rows[:, 0].any():
        raise AssertionError(f"{path}: not an unfiltered 8-bit RGB PNG")
    return rows[:, 1:].reshape(h, w, 3)


def run_cli(argv) -> str:
    """`cli.main(argv)` in this process; raises unless it returns 0.
    Returns what it printed."""
    import contextlib
    import io
    from path_tracer_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"cli {argv} returned {rc}")
    return out


def kernel_ops(trace_path: str, launches: int) -> dict:
    """From a Chrome trace of `torch.profiler`: each CUDA kernel's total
    device time (ms) and count, and the host's top-level PyTorch ops (those
    not inside another op on the same thread) a K1 launch."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kern = {}
    for e in events:
        if e.get("cat") == "kernel":
            ms, n = kern.get(e["name"], (0.0, 0))
            kern[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                 key=lambda e: (e["tid"], e["ts"], -e.get("dur", 0)))
    top, end = 0, {}
    for e in ops:
        if e["ts"] >= end.get(e["tid"], -1.0):
            top += 1
            end[e["tid"]] = e["ts"] + e.get("dur", 0)
    return dict(kernels=kern, host_ops=len(ops), top_host_ops=top,
                top_ops_a_bounce=top / max(launches, 1))


class keep_launch:
    """Within the block, copy the inputs of K1's KEPT_LAUNCH-th launch at
    the first (widest) lane count that has live lanes, for `check_kept`.
    The windowed driver's windows run eagerly there (`eager_driver`)."""

    def __init__(self):
        from path_tracer_tpu_torch.ops import wave_bounce as WB
        self.WB, self.seen, self.args = WB, 0, None

    def __enter__(self):
        self.eager = eager_driver().__enter__()
        launch = self.launch = self.WB._launch

        def hook(tables, st, fix, texel, srv, t_min, max_depth, attenuate,
                 split=None):
            if self.seen == 0:
                self.lanes = st.ox.numel()
            if (self.args is None and st.ox.numel() == self.lanes
                    and bool((st.alive > 0).any())):
                self.seen += 1
                if self.seen == KEPT_LAUNCH:
                    self.args = (tables, *(
                        type(x)(*[t.clone() for t in x])
                        if isinstance(x, tuple) else x.clone()
                        for x in (st, fix, texel, srv)))
                    self.kw = dict(t_min=t_min, max_depth=max_depth,
                                   attenuate=attenuate)
            return launch(tables, st, fix, texel, srv, t_min, max_depth,
                          attenuate, split)

        self.WB._launch = hook
        return self

    def __exit__(self, *exc):
        self.WB._launch = self.launch
        self.eager.__exit__(*exc)


def check_kept(what: str, kept: keep_launch, tag: str = "11") -> dict:
    """The kept launch through the wrapper (its own K) bit-equal to the
    plain version on every plane, as phase 10 holds every K; its time,
    the plain version's and the bound."""
    WB = kept.WB
    if kept.args is None:
        raise AssertionError(f"{what}: no launch {KEPT_LAUNCH} at full "
                             f"width")
    tables, st, fix, texel, srv = kept.args
    kw = kept.kw
    call = lambda: WB.wave_bounce(tables, st, fix, texel, srv,
                                  tile_rows=st.ox.shape[0], **kw)
    plain = WB.wave_bounce_plain(tables, st, fix, texel, srv, **kw)
    kern = call()
    if not all(torch.equal(x, y) for x, y in zip(k1_bits(kern),
                                                 k1_bits(plain))):
        raise AssertionError(f"{what}: the kept launch is not bit-equal to "
                             f"the plain version")
    _, max_abs = k1_compare(kern, plain, what)
    ms = cuda_ms(call, 20)
    plain_ms = cuda_ms(lambda: WB.wave_bounce_plain(tables, st, fix, texel,
                                                    srv, **kw), 2)
    nbytes, ops = k1_bound(tables, st, fix, srv)
    t_b, t_o = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    row = dict(lanes=st.ox.numel(), K=WB.split_for(st.ox.numel()), ms=ms,
               plain_ms=plain_ms, bound_ms=max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations",
               max_abs_err=max_abs)
    log(f"[{tag}] {what}: launch {KEPT_LAUNCH} at {row['lanes']} lanes (K="
        f"{row['K']}) bit-equal to plain; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']})")
    return row


def phase_app(dev) -> tuple:
    """11. The app surface through the command line; returns K1's
    kernels-line row for the app path, and the final scene's 8-spp
    `render_wq` frame and segments (for phase 14)."""
    import shutil
    from path_tracer_tpu_torch import cli
    from path_tracer_tpu_torch.engine import checkpoint as CK
    from path_tracer_tpu_torch.engine.wq import render_wq
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    from path_tracer_tpu_torch.scene.presets import PRESETS
    from path_tracer_tpu_torch.utils import profiling

    info = json.loads(run_cli(["info"]))
    log(f"[11] info: backend {info['backend']}, devices {info['devices']}")
    if info["backend"] != "cuda" or len(info["devices"]) != 1:
        raise AssertionError(f"info: want backend cuda and one device, got "
                             f"{info['backend']} {info['devices']}")

    # every preset through the kernel and through the plain version: the
    # two are bit-equal by design, so the frames must be equal
    frame_err = 0.0
    for name in PRESETS:
        out = {}
        for d in ("cuda", "cpu"):
            scene, cam = cli.preset_scene(name, 32, 24, d)
            WB.wave_bounce.launches = 0
            img, segs, iters, _ = render_wq(scene, cam, 32, 24, 4,
                                            max_depth=8, tile_rows=8,
                                            window=3, return_stats=True,
                                            device=d)
            out[d] = (img.cpu().numpy(), segs, iters)
            if d == "cuda" and WB.wave_bounce.launches != iters:
                raise AssertionError(f"{name}: {WB.wave_bounce.launches} "
                                     f"launches for {iters} iterations")
        (k_img, k_segs, k_iters), (p_img, p_segs, p_iters) = (
            out["cuda"], out["cpu"])
        max_abs = float(np.abs(k_img - p_img).max())
        frame_err = max(frame_err, max_abs)
        log(f"[11] {name} 32x24x4 depth 8, kernel vs plain: max "
            f"{max_abs}, segments {k_segs} / {p_segs}, iters {k_iters} / "
            f"{p_iters}")
        if not (np.isfinite(k_img).all() and max_abs == 0
                and k_segs == p_segs and k_iters == p_iters):
            raise AssertionError(f"{name}: the kernel's frame differs from "
                                 f"the plain version's")

    # every preset at its own size and depth through `render`, one of its
    # full-width launches kept and held bit-equal to the plain version
    os.makedirs("build", exist_ok=True)
    kept_rows = {}
    for name, p in PRESETS.items():
        png = os.path.join("build", f"cli_{name}.png")
        with keep_launch() as kept:
            text = run_cli(["render", "--scene", name, "--spp",
                            str(APP_SPP), "--device", "cuda", "-o", png,
                            "--metrics"])
        metrics = json.loads(text.strip().splitlines()[-1])
        shape = read_png(png).shape
        if shape != (p.height, p.width, 3):
            raise AssertionError(f"{png} is {shape}, not {p.height}x"
                                 f"{p.width}")
        scene, cam = cli.preset_scene(name, p.width, p.height, dev)
        t0 = time.perf_counter()
        img, segs, iters, _ = render_wq(scene, cam, p.width, p.height,
                                        APP_SPP, p.max_depth,
                                        return_stats=True, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if name == "final_scene":
            frame8 = dict(frame=img.cpu().numpy(), segs=segs)
        log(f"[11] render {name} {p.width}x{p.height}x{APP_SPP} depth "
            f"{p.max_depth}: {json.dumps(metrics)}; render_wq alone "
            f"{dt:.4f} s, {segs / dt / 1e6:.3f} Mray/s, {iters} iterations")
        kept_rows[name] = check_kept(f"render {name}", kept)

    # the final scene through --checkpoint-dir
    saves, loads = [], []
    save, load = CK._save_atomic, CK.load_checkpoint

    def timed(fn, into):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                into.append(time.perf_counter() - t0)
        return call

    dirs = [os.path.join("build", f"ckpt_{x}") for x in "ab"]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    runs = [(dirs[0], 8), (dirs[0], 16), (dirs[1], 16)]
    walls = []
    CK._save_atomic, CK.load_checkpoint = timed(save, saves), timed(load,
                                                                    loads)
    WB.wave_bounce.launches = 0
    try:
        for d, spp in runs:
            t0 = time.perf_counter()
            run_cli(["render", "--scene", "final_scene", "--width", str(W),
                     "--height", str(H), "--max-depth", str(DEPTH), "--spp",
                     str(spp), "--checkpoint-dir", d, "--checkpoint-every",
                     str(CKPT_EVERY), "--device", "cuda", "-o",
                     os.path.join(d, "final.png")])
            walls.append(time.perf_counter() - t0)
    finally:
        CK._save_atomic, CK.load_checkpoint = save, load
    ck_launches = WB.wave_bounce.launches
    accs = [np.load(os.path.join(d, "accum.npz"))["acc"] for d in dirs]
    if not np.array_equal(accs[0].view(np.uint32), accs[1].view(np.uint32)):
        raise AssertionError("the resumed accumulator differs from the "
                             "uninterrupted one")
    scene, cam = cli.preset_scene("final_scene", W, H, dev)
    ref = render_wq(scene, cam, W, H, 16, DEPTH, device=dev).cpu().numpy()
    mean = (accs[0] / np.float32(16)).reshape(H, W, 3)
    ck_err = float(np.abs(mean - ref).max())
    log(f"[11] checkpointed final scene {W}x{H} depth {DEPTH}: walls "
        f"{[round(x, 4) for x in walls]} s (8 spp, resumed to 16, fresh 16, "
        f"ranges of {CKPT_EVERY}); {len(saves)} saves "
        f"{[round(x, 4) for x in saves]} s, {len(loads)} loads "
        f"{[round(x, 4) for x in loads]} s; accumulators bit-equal; mean vs "
        f"render_wq at 16 spp max {ck_err:.3g}; K1 launches {ck_launches}")
    if ck_err > 2e-4 or ck_launches == 0:
        raise AssertionError("checkpointed render: mean off render_wq or no "
                             "kernel launch")

    log(f"[11] bench: {run_cli(['bench']).strip()}")

    prof = os.path.join("build", "profile")
    shutil.rmtree(prof, ignore_errors=True)
    WB.wave_bounce.launches = 0
    text = run_cli(["render", "--scene", "three_spheres", "--device", "cuda",
                    "--profile-dir", prof, "--metrics", "-o",
                    os.path.join("build", "prof.png")])
    render_s = json.loads(text.strip().splitlines()[-1])["phases_s"][
        "compile+render"]
    k = kernel_ops(os.path.join(prof, profiling.TRACE_FILE),
                   WB.wave_bounce.launches)
    top = sorted(k["kernels"].items(), key=lambda x: -x[1][0])[:10]
    k1 = [v for n, v in k["kernels"].items() if "wave_kernel" in n]
    all_ms = sum(ms for ms, _ in k["kernels"].values())
    log(f"[11] profile of three_spheres: {WB.wave_bounce.launches} K1 "
        f"launches; kernels {len(k['kernels'])} names, "
        f"{sum(c for _, c in k['kernels'].values())} launches, {all_ms:.3f} "
        f"ms of device time ({100 * all_ms / 1e3 / render_s:.1f}% of the "
        f"{render_s} s render under the profiler), of which K1 "
        f"{sum(m for m, _ in k1):.3f} ms in {sum(c for _, c in k1)}; top "
        f"kernels by device time (ms, count): "
        + "; ".join(f"{n[:80]} {ms:.3f} ({c})" for n, (ms, c) in top))
    log(f"[11] host ops: {k['host_ops']} in all, {k['top_host_ops']} top "
        f"level, {k['top_ops_a_bounce']:.1f} top-level a bounce; device "
        f"memory {json.dumps(profiling.device_memory_stats())}")
    if not any("wave_kernel" in n for n in k["kernels"]):
        raise AssertionError("the profiler trace names no wave_kernel")

    # the row: the checkpointed renders' launches, the final scene's kept
    # launch at full width, the largest difference of any frame or launch
    row = kept_rows["final_scene"]
    return dict(name="wave_bounce", path="app", route="cuda",
                source="path_tracer_tpu_torch/ops/csrc/wave_bounce.cu",
                replaces="path_tracer_tpu/ops/pallas/wave_bounce.py:536",
                launches=ck_launches,
                max_abs_err=max([frame_err] + [r["max_abs_err"]
                                               for r in kept_rows.values()]),
                ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=None, presets=kept_rows), frame8


def warm_mesh(mesh, dev) -> None:
    """One reduction on each axis group (NCCL sets a communicator up at
    its first collective), then the mesh's counters from zero."""
    for axis in ("tiles", "spp"):
        mesh.psum(torch.zeros(1, device=dev), axis)
    mesh.collective_s, mesh.collectives = 0.0, 0


def sharded_rank(target: np.ndarray) -> dict:
    """12 (b) and (c), one of two ranks on the one card (gloo): the final
    scene at 800x600, depth 50, SHARD_SPP spp on a (2x1) and a (1x2) mesh,
    assembled; then one train step on a (2x1) mesh at phase 9's setting
    from its perturbation, toward its target.  Each with its wall time,
    K1's launches and iterations (for the step, the recorded steps of the
    rank's half of the pixels, as phase 9 counts them), and the
    collectives' time."""
    from path_tracer_tpu_torch.diff import params as P
    from path_tracer_tpu_torch.diff import queued_vjp as Q
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    from path_tracer_tpu_torch.parallel.mesh import (make_mesh,
                                                     make_train_step,
                                                     render_sharded,
                                                     scene_camera_params)
    from path_tracer_tpu_torch.parallel.multihost import assemble_image
    from path_tracer_tpu_torch.scene.presets import build_final_scene
    out = {}
    for shape in ((2, 1), (1, 2)):
        mesh = make_mesh(*shape)
        dev = mesh.device
        scene, cam = build_final_scene(W / H, device=dev)
        warm_mesh(mesh, dev)
        WB.wave_bounce.launches = 0
        t0 = time.perf_counter()
        fb, segs, iters, _ = render_sharded(scene, cam, W, H, SHARD_SPP,
                                            mesh, max_depth=DEPTH,
                                            return_stats=True)
        frame = assemble_image(fb, mesh, W, H)
        torch.cuda.synchronize()
        out[shape] = dict(frame=frame, wall=time.perf_counter() - t0,
                          launches=WB.wave_bounce.launches, iters=iters,
                          segs=segs, collective_s=mesh.collective_s,
                          collectives=mesh.collectives)
    mesh = make_mesh(2, 1)
    dev = mesh.device
    scene, cam = build_final_scene(GW / GH, device=dev)
    params, (s_scene, s_cam) = scene_camera_params(scene, cam)
    step = make_train_step(s_scene, s_cam, GW, GH, GSPP, DEPTH, lr=TRAIN_LR,
                           grad_filter=only_material_colors, mesh=mesh)
    cfg = Q.render_grad_fb(GW, GH, GW * GH // mesh.n_tiles, GSPP,
                           max_depth=DEPTH, device=dev).cfg
    warm_mesh(mesh, dev)
    WB.wave_bounce.launches = 0
    t0 = time.perf_counter()
    new, loss = step(perturb_colors(params),
                     torch.from_numpy(target).to(dev),
                     torch.arange(GW * GH, device=dev))
    loss = float(loss)
    out["train"] = dict(loss=loss, wall=time.perf_counter() - t0,
                        params=[x.cpu().numpy() for x in P.leaves(new)],
                        launches=WB.wave_bounce.launches,
                        steps=(cfg["n_windows"] + cfg["n_windows_b"])
                        * cfg["window"],
                        collective_s=mesh.collective_s,
                        collectives=mesh.collectives)
    return out


def phase_sharded(dev, frame: np.ndarray, first: dict) -> dict:
    """12. Multi-device: (a) world size 1 on NCCL, phase 5's frame through
    `render_sharded` on a 1x1 mesh, bit-equal to it; (b) two gloo ranks
    on this card at (2x1) and (1x2), each assembled frame against one
    `render_wq` within rtol 1e-5, atol 1e-6; (c) one train step on two
    ranks at (2x1) against phase 9's first step (loss within 1e-5
    relative, each param leaf within 1e-5 relative L2), both ranks' params
    bit-equal; (d) `dryrun_multichip(2)`.  Returns K1's kernels-line row
    for the sharded path: the launches of (a)-(c), the fifth full-width
    launch of (a) kept and held bit-equal to the plain version."""
    import torch.distributed as dist
    from path_tracer_tpu_torch import dryrun
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    from path_tracer_tpu_torch.parallel import launch
    from path_tracer_tpu_torch.parallel.mesh import make_mesh, render_sharded
    from path_tracer_tpu_torch.parallel.multihost import assemble_image
    from path_tracer_tpu_torch.engine.wq import render_wq
    from path_tracer_tpu_torch.scene.presets import build_final_scene

    scene, cam = build_final_scene(W / H, device=dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{launch.free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        warm_mesh(mesh, dev)
        WB.wave_bounce.launches = 0
        with keep_launch() as kept:
            t0 = time.perf_counter()
            fb, segs, iters, _ = render_sharded(scene, cam, W, H, SPP, mesh,
                                                max_depth=DEPTH,
                                                return_stats=True)
            img = assemble_image(fb, mesh, W, H)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches_a = WB.wave_bounce.launches
        backend = dist.get_backend(mesh.spp_group)
    finally:
        dist.destroy_process_group()
    same = np.array_equal(img.view(np.uint32), frame.view(np.uint32))
    log(f"[12] (a) world size 1 on {backend}, 1x1 mesh, {W}x{H}x{SPP} "
        f"depth {DEPTH}: {dt:.3f} s, {segs / dt / 1e6:.3f} Mray/s, "
        f"launches {launches_a} (iterations {iters}), collectives "
        f"{mesh.collectives} in {mesh.collective_s * 1e3:.2f} ms; "
        f"bit-equal to phase 5's frame: {same}")
    if not same or launches_a != iters or backend != "nccl":
        raise AssertionError("(a): the 1x1 NCCL frame differs from "
                             "render_wq's, or the launches from the "
                             "iterations")
    row = check_kept("sharded (a)", kept, tag="12")

    ref8 = render_wq(scene, cam, W, H, SHARD_SPP, max_depth=DEPTH,
                     device=dev).cpu().numpy()
    t0 = time.perf_counter()
    ranks = launch.spawn(sharded_rank, 2, (first["target"],), device="cuda")
    log(f"[12] (b, c) two ranks on one card over "
        f"{launch.default_backend('cuda', 2)}: "
        f"{time.perf_counter() - t0:.1f} s with their start")
    frame_err = 0.0
    for shape in ((2, 1), (1, 2)):
        for r, res in enumerate(ranks):
            x = res[shape]
            err = float(np.abs(x["frame"] - ref8).max())
            frame_err = max(frame_err, err)
            log(f"[12] (b) {shape[0]}x{shape[1]} rank {r}: {W}x{H}x"
                f"{SHARD_SPP} depth {DEPTH} in {x['wall']:.3f} s, "
                f"{x['segs'] / x['wall'] / 1e6:.3f} Mray/s of its own "
                f"segments; launches {x['launches']} (iterations "
                f"{x['iters']}); collectives {x['collectives']} in "
                f"{x['collective_s'] * 1e3:.2f} ms; max |frame - render_wq|"
                f" {err:.3g}")
            if x["launches"] != x["iters"] or x["launches"] == 0:
                raise AssertionError(f"(b) {shape} rank {r}: launches "
                                     f"{x['launches']}, iterations "
                                     f"{x['iters']}")
            np.testing.assert_allclose(x["frame"], ref8, rtol=1e-5,
                                       atol=1e-6)
    worst = 0.0
    for r, res in enumerate(ranks):
        t = res["train"]
        for a, b in zip(t["params"], first["params"]):
            a, b = a.astype(np.float64), b.astype(np.float64)
            worst = max(worst, float(np.linalg.norm(a - b))
                        / max(float(np.linalg.norm(b)), 1e-30))
        log(f"[12] (c) 2x1 train step rank {r}: loss {t['loss']} (one "
            f"device {first['loss']}), {t['wall']:.3f} s, launches "
            f"{t['launches']} for {t['steps']} recorded steps, collectives "
            f"{t['collectives']} in {t['collective_s'] * 1e3:.2f} ms")
        if not abs(t["loss"] - first["loss"]) <= 1e-5 * first["loss"]:
            raise AssertionError(f"(c) rank {r}: loss {t['loss']} vs "
                                 f"{first['loss']}")
        if t["launches"] != t["steps"]:
            raise AssertionError(f"(c) rank {r}: the step launched the "
                                 f"kernel {t['launches']} times, not "
                                 f"{t['steps']}")
    same = all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
               for a, b in zip(ranks[0]["train"]["params"],
                               ranks[1]["train"]["params"]))
    log(f"[12] (c) params: worst leaf relative L2 to the one-device step "
        f"{worst:.3g}; the two ranks' params bit-equal: {same}")
    if worst > 1e-5 or not same:
        raise AssertionError("(c): the sharded step's params differ")

    t0 = time.perf_counter()
    d = dryrun.dryrun_multichip(2)
    log(f"[12] (d) dryrun_multichip(2) in {time.perf_counter() - t0:.1f} s "
        f"with its start: {json.dumps(d)}")

    launches = launches_a + sum(res[s]["launches"] for res in ranks
                                for s in ((2, 1), (1, 2))) + sum(
        res["train"]["launches"] for res in ranks)
    return dict(name="wave_bounce", path="sharded", route="cuda",
                source="path_tracer_tpu_torch/ops/csrc/wave_bounce.cu",
                replaces="path_tracer_tpu/ops/pallas/wave_bounce.py:536",
                launches=launches,
                max_abs_err=row["max_abs_err"], frame_err=frame_err,
                ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=None, mray_s_1x1=segs / dt / 1e6,
                launches_by_part=dict(
                    a=launches_a,
                    b=[res[s]["launches"] for res in ranks
                       for s in ((2, 1), (1, 2))],
                    c=[res["train"]["launches"] for res in ranks]))


# phase 13's frames: (a) render_wavefront against render_wq, (b)
# render_parity banded and unbanded, and on the card and the CPU, (c) the
# chunked oracle renderers, (d) the command line, (e) checked_render, (f)
# render_sharded's jnp renderer, (g) the jnp train step.  (c) and (f) run
# cornell_box at depth 8, not its 50: at 50 their host loops took ~1,000
# bounces and ~50 s, which kept the script past the time it had before
ORACLE = dict(
    wavefront=(W, H, 8, DEPTH), parity=(W, H, 1, DEPTH), parity_bands=100,
    parity_crop=(48, 64), parity_small=(40, 24, 1, DEPTH),
    chunked=("cornell_box", 8, 8), cli="three_spheres", ckpt=(8, 4),
    checked=(32, 32, 2, 8), train=(GW, GH, GSPP, DEPTH))


def envelope(img, ref, tol=5e-3, frac=0.03):
    """tests/test_wq.py's final-scene envelope: at most `frac` of the
    pixels beyond `tol`.  Returns (fraction beyond, largest difference)."""
    d = np.abs(img - ref).max(axis=-1)
    bad = float((d > tol).mean())
    if img.shape != ref.shape or not np.isfinite(img).all() or bad > frac:
        raise AssertionError(f"outside the envelope: {bad:.4f} of pixels "
                             f"beyond {tol}, max {float(d.max()):.4g}")
    return bad, float(d.max())


def peak_gib(dev) -> float:
    return (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else 0.0)


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def jnp_loss_frame(scene, cam, w, h, spp, depth, dev):
    """The jnp train step's image (the mean of `spp` samples a pixel,
    emission attenuated, seed 0) without autograd."""
    from path_tracer_tpu_torch.core.rng import seed_perf
    from path_tracer_tpu_torch.engine.integrator import camera_rays, trace
    pix = torch.arange(w * h, device=dev).repeat(spp)
    samp = torch.arange(spp, device=dev).repeat_interleave(w * h)
    state, o, d, t = camera_rays(cam, w, h, pix, seed_perf(pix, samp, 0))
    with torch.no_grad():
        _, rad = trace(scene, o, d, t, state, depth,
                       attenuate_emission=True)
    return torch.stack([c.reshape(spp, w * h).mean(0) for c in rad], -1)


def phase_oracle(dev, sizes=None) -> dict:
    """13. The oracle engines (torch ops, no hand kernel) on the device
    through their entry points, (a)-(g) as the module docstring says;
    `sizes` overrides ORACLE's (a CPU rehearsal takes small ones)."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from path_tracer_tpu_torch.diff import params as P
    from path_tracer_tpu_torch.engine import checkpoint as CK
    from path_tracer_tpu_torch.engine import integrator as I
    from path_tracer_tpu_torch.engine.wq import render_wq
    from path_tracer_tpu_torch.parallel import launch
    from path_tracer_tpu_torch.parallel.mesh import (make_mesh,
                                                     make_train_step,
                                                     render_sharded,
                                                     scene_camera_params)
    from path_tracer_tpu_torch.scene.presets import PRESETS, build_final_scene
    from path_tracer_tpu_torch.utils.debug import checked_render
    z = dict(ORACLE, **(sizes or {}))
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    out = {}

    # (a) render_wavefront against render_wq
    w, h, spp, depth = z["wavefront"]
    scene, cam = build_final_scene(w / h, device=dev)
    reset_peak(dev)
    t0 = time.perf_counter()
    img, st = I.render_wavefront(scene, cam, w, h, spp, max_depth=depth,
                                 seed=0, return_stats=True, device=dev)
    img = img.cpu().numpy()
    wall = time.perf_counter() - t0
    peak = peak_gib(dev)
    ref = render_wq(scene, cam, w, h, spp, max_depth=depth, seed=0,
                    device=dev).cpu().numpy()
    bad, worst = envelope(img, ref)
    out["a"] = dict(wall_s=wall, peak_gib=peak, beyond=bad, max_diff=worst,
                    **st)
    log(f"[13] (a) render_wavefront, final scene {w}x{h}x{spp} depth "
        f"{depth}: {wall:.3f} s, {st['segments']} segments, {st['iters']} "
        f"iterations, {st['lanes']} lanes in {st['tiles']} tile(s), peak "
        f"{peak:.2f} GiB; against render_wq {bad:.4f} of "
        f"pixels beyond 5e-3 (max {worst:.3g})")

    # (b) render_parity: banded = unbanded; the card against the CPU
    w, h, spp, depth = z["parity"]
    reset_peak(dev)
    t0 = time.perf_counter()
    banded = I.render_parity(scene, cam, w, h, spp, depth,
                             band_rows=z["parity_bands"],
                             device=dev).cpu().numpy()
    t_band = time.perf_counter() - t0
    peak_band = peak_gib(dev)
    reset_peak(dev)
    t0 = time.perf_counter()
    whole = I.render_parity(scene, cam, w, h, spp, depth,
                            device=dev).cpu().numpy()
    t_whole = time.perf_counter() - t0
    peak_whole = peak_gib(dev)
    ch_, cw_ = z["parity_crop"]
    if not (np.array_equal(banded, whole)
            and np.array_equal(banded[:ch_, :cw_], whole[:ch_, :cw_])):
        raise AssertionError("(b): the banded parity frame differs")
    sw, sh, sspp, sdepth = z["parity_small"]
    small = {}
    for d in (dev, torch.device("cpu")):
        s_scene, s_cam = build_final_scene(sw / sh, device=d)
        small[d.type] = I.render_parity(s_scene, s_cam, sw, sh, sspp,
                                        sdepth, device=d).cpu().numpy()
    differ = int((small[dev.type] != small["cpu"]).any(-1).sum())
    out["b"] = dict(banded_s=t_band, whole_s=t_whole,
                    banded_peak_gib=peak_band, whole_peak_gib=peak_whole,
                    small_differing_pixels=differ)
    log(f"[13] (b) render_parity, final scene {w}x{h}x{spp} depth {depth}: "
        f"bands of {z['parity_bands']} rows {t_band:.3f} s, peak "
        f"{peak_band:.2f} GiB; unbanded {t_whole:.3f} s, peak "
        f"{peak_whole:.2f} GiB; equal (the {cw_}x{ch_} crop too); {sw}x{sh} "
        f"on {dev.type} and cpu: {differ} differing pixels")
    if differ:
        envelope(small[dev.type], small["cpu"])
    del scene, cam

    # (c) render_fused, render_perf against render_wavefront
    name, spp, depth = z["chunked"]
    pr = PRESETS[name]
    scene, cam = pr.build(device=dev)
    w, h = pr.width, pr.height
    t0 = time.perf_counter()
    ref = I.render_wavefront(scene, cam, w, h, spp, max_depth=depth,
                             device=dev).cpu().numpy()
    times = {"wavefront": time.perf_counter() - t0}
    chunked = {}
    for fn in ("fused", "perf"):
        t0 = time.perf_counter()
        chunked[fn] = getattr(I, f"render_{fn}")(
            scene, cam, w, h, spp, max_depth=depth, device=dev).cpu().numpy()
        times[fn] = time.perf_counter() - t0
        bad, worst = envelope(chunked[fn], ref)
        log(f"[13] (c) render_{fn}, {name} {w}x{h}x{spp} depth {depth}: "
            f"{times[fn]:.3f} s (render_wavefront {times['wavefront']:.3f} "
            f"s); {bad:.4f} of pixels beyond 5e-3 (max {worst:.3g})")
    out["c"] = times

    # (f) render_sharded(renderer="jnp") at world size 1 against render_perf
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{launch.free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, device=dev)
        t0 = time.perf_counter()
        fb = render_sharded(scene, cam, w, h, spp, mesh, max_depth=depth,
                            renderer="jnp")
        sync()
        t_sh = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(fb.reshape(h, w, 3).cpu().numpy(),
                               chunked["perf"], rtol=1e-5, atol=1e-6)
    out["f"] = dict(wall_s=t_sh, backend=backend)
    log(f"[13] (f) render_sharded(renderer='jnp'), 1x1 mesh on {backend}, "
        f"{name} {w}x{h}x{spp} depth {depth}: {t_sh:.3f} s, within rtol 1e-5 atol 1e-6 "
        f"of render_perf")
    del scene, cam

    # (d) the command line's oracle renderers, and the jnp checkpoint loop
    tmp = tempfile.mkdtemp(prefix="chip_smoke_oracle_")
    try:
        name = z["cli"]
        pr = PRESETS[name]
        for r in ("parity", "wavefront", "fused", "perf"):
            png = os.path.join(tmp, f"{r}.png")
            t0 = time.perf_counter()
            run_cli(["render", "--scene", name, "--renderer", r,
                     "--device", dev.type, "-o", png])
            back = read_png(png)
            log(f"[13] (d) cli render --scene {name} --renderer {r}: "
                f"{time.perf_counter() - t0:.3f} s, PNG {back.shape}")
            if back.shape != (pr.height, pr.width, 3):
                raise AssertionError(f"(d) {r}: PNG {back.shape}")
        scene, cam = pr.build(device=dev)
        ck_spp, half = z["ckpt"]
        # ranges of `half` samples: max_lanes holds that many a pixel
        kw = dict(checkpoint_every=half, scene_name=name, renderer="jnp",
                  max_lanes=half * pr.width * pr.height, device=dev)
        d1 = os.path.join(tmp, "resumed")
        CK.render_checkpointed(scene, cam, pr.width, pr.height, half,
                               pr.max_depth, ckpt_dir=d1, **kw)
        t0 = time.perf_counter()
        CK.render_checkpointed(scene, cam, pr.width, pr.height, ck_spp,
                               pr.max_depth, ckpt_dir=d1, **kw)
        t_res = time.perf_counter() - t0
        d2 = os.path.join(tmp, "fresh")
        CK.render_checkpointed(scene, cam, pr.width, pr.height, ck_spp,
                               pr.max_depth, ckpt_dir=d2, **kw)
        ident = dict(scene=name, width=pr.width, height=pr.height,
                     max_depth=pr.max_depth, seed=0, t_min=1e-3,
                     attenuate_emission=False, renderer="jnp")
        a1, n1 = CK.load_checkpoint(d1, ident)
        a2, n2 = CK.load_checkpoint(d2, ident)
        if n1 != ck_spp or n2 != ck_spp or not np.array_equal(a1, a2):
            raise AssertionError("(d): the resumed jnp accumulator differs")
        log(f"[13] (d) render_checkpointed(renderer='jnp'), {name}: {half} "
            f"spp, resumed to {ck_spp} in {t_res:.3f} s, bit-equal to a "
            f"fresh {ck_spp}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (e) checked_render
    w, h, spp, depth = z["checked"]
    scene, cam = PRESETS["cornell_box"].build(device=dev)
    t0 = time.perf_counter()
    img = checked_render(scene, cam, w, h, spp, max_depth=depth, device=dev)
    t_chk = time.perf_counter() - t0
    assert_finite = np.isfinite(img.cpu().numpy()).all()
    c1 = scene.textures.c1
    nan_scene = scene._replace(textures=scene.textures._replace(
        c1=type(c1)(torch.full_like(c1.x, float("nan")), c1.y, c1.z)))
    try:
        checked_render(nan_scene, cam, w, h, 1, max_depth=depth, device=dev)
    except FloatingPointError as e:
        log(f"[13] (e) checked_render, cornell_box {w}x{h}x{spp}: "
            f"{t_chk:.3f} s, finite {assert_finite}; the NaN scene raised: "
            f"{e}")
    else:
        raise AssertionError("(e): the NaN scene did not raise")
    if not assert_finite:
        raise AssertionError("(e): checked_render's image is not finite")

    # (g) two jnp train steps with the silhouette term
    w, h, spp, depth = z["train"]
    scene, cam = build_final_scene(w / h, device=dev)
    sph = scene.spheres
    # the metal sphere at (0, 1, -2.25): its silhouette and its colour
    i = int(torch.argmin((sph.c0.x - 0.0).abs() + (sph.c0.y - 1.0).abs()
                         + (sph.c0.z + 2.25).abs()))
    m = int(sph.mat[i])
    target = jnp_loss_frame(scene, cam, w, h, spp, depth, dev)
    params, (s_scene, s_cam) = scene_camera_params(scene, cam)
    params = perturb_colors(params)

    def keep(grads):
        g = only_material_colors(grads)
        s = grads[0].spheres
        mask = torch.zeros_like(s.radius)
        mask[i] = 1.0
        return (g[0]._replace(spheres=g[0].spheres._replace(
            c0=type(s.c0)(*(c * mask for c in s.c0)),
            radius=s.radius * mask)), g[1])

    step = make_train_step(s_scene, s_cam, w, h, spp, depth, lr=TRAIN_LR,
                           grad_filter=keep, device=dev, backend="jnp",
                           geometry_edge=[i])
    pix = torch.arange(w * h, device=dev)
    p0 = params
    losses, walls = [], []
    reset_peak(dev)
    for _ in range(2):
        t0 = time.perf_counter()
        params, loss = step(params, target, pix)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
        if len(losses) == 1:
            p1 = params
    g = float((p0[0].materials.color.x[m] - p1[0].materials.color.x[m])
              / TRAIN_LR)

    def loss_at(v):
        s_, c_ = P.combine(p0, (s_scene, s_cam))
        col = s_.materials.color
        x = col.x.clone()
        x[m] = v
        s_ = s_._replace(materials=s_.materials._replace(
            color=type(col)(x, col.y, col.z)))
        err = jnp_loss_frame(s_, c_, w, h, spp, depth, dev) - target
        return float((err * err).sum()) / (w * h * 3)

    x0, eps = float(p0[0].materials.color.x[m]), 1e-2
    fd = (loss_at(x0 + eps) - loss_at(x0 - eps)) / (2 * eps)
    moved = [float((p1[0].spheres.radius[i] - p0[0].spheres.radius[i])),
             float((p1[0].spheres.c0.x[i] - p0[0].spheres.c0.x[i]))]
    out["g"] = dict(losses=losses, step_s=walls, peak_gib=peak_gib(dev),
                    grad=g, fd=fd, sphere=i, edge_moved=moved)
    log(f"[13] (g) make_train_step(backend='jnp', geometry_edge=[{i}]), "
        f"final scene {w}x{h}x{spp} depth {depth}, lr {TRAIN_LR}: losses "
        f"{losses}, {walls[0]:.3f} / {walls[1]:.3f} s a step, peak "
        f"{out['g']['peak_gib']:.2f} GiB; d loss / d colour.x[{m}] {g:.6g} "
        f"against the finite difference {fd:.6g}; sphere {i}'s radius and "
        f"centre x moved {moved}")
    if not (all(np.isfinite(losses)) and losses[0] > losses[1]):
        raise AssertionError(f"(g): the loss did not fall: {losses}")
    if not abs(g - fd) <= 2e-2 * abs(fd):
        raise AssertionError(f"(g): gradient {g} against FD {fd}")
    if not all(v != 0.0 for v in moved):
        raise AssertionError("(g): the silhouette term moved nothing")
    return out


# ---- 14. the one-bounce driver and the pinned gradient route ----------------

PHASE14 = dict(
    one_bounce=(W, H, 8, DEPTH),   # (a): the one-bounce driver's frame
    small=(32, 24, 4, 8),          # (a): kernel against plain
    pinned=(GW, GH, GSPP, DEPTH),  # (b), (c): phase 8's setting
    pairs=4096,                    # (c): the non-canonical list
    tile_rows=None)                # the drivers' default
# (b): per-leaf relative L2, pinned against queued, on the loss over the
# pixels no box touches: the two replays gather and scatter in different
# orders (unordered index_add_ on the card); measured 2.0e-6 at worst
# (NVIDIA H100 80GB HBM3, 700 W), so 1e-4 leaves room for the atomics'
# order and catches any difference of estimator
PINNED_RTOL = 1e-4
# leaves the pinned replay detaches by design (the camera's shutter time,
# the reference's pallas_vjp.py:218), whose gradient it leaves at zero
PINNED_DETACHED = ("camera.time0", "camera.time1")


def count_syncs(dev, fn):
    """(fn(), the synchronising calls it made, any direction) on CUDA, by
    torch.cuda's sync debug mode; (fn(), None) elsewhere."""
    import warnings
    if dev.type != "cuda":
        return fn(), None
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def phase_one_bounce(dev, frame8, sizes=None) -> dict:
    """14 (a). `render_wq(window=1)`: the 32x24 frame through the kernel
    and through the plain version (equal), then the final scene at
    800x600, depth 50, 8 spp against phase 11's windowed frame (segments
    within 0.2%, the envelope), its launches, host synchronisations and
    kept launch.  `sizes` overrides PHASE14's (a CPU rehearsal)."""
    from path_tracer_tpu_torch.engine.wq import render_wq
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    from path_tracer_tpu_torch.scene.presets import build_final_scene
    sz = dict(PHASE14, **(sizes or {}))
    sw, sh, sspp, sdepth = sz["small"]
    small = {}
    for d in (dev.type, "cpu"):
        s_, c_ = build_final_scene(sw / sh, device=d)
        WB.wave_bounce.launches = 0
        img, segs, iters, _ = render_wq(s_, c_, sw, sh, sspp,
                                        max_depth=sdepth, tile_rows=8,
                                        window=1, return_stats=True,
                                        device=d)
        small[d] = (img.cpu().numpy(), segs, iters, WB.wave_bounce.launches)
    (k_img, k_segs, k_it, k_n), (p_img, p_segs, p_it, _) = (
        small[dev.type], small["cpu"])
    err = float(np.abs(k_img - p_img).max())
    log(f"[14] (a) one-bounce render_wq {sw}x{sh}x{sspp} depth {sdepth}, "
        f"kernel vs plain: max {err}, segments {k_segs} / {p_segs}, "
        f"iterations {k_it} / {p_it}, K1 launches {k_n}")
    if not (np.isfinite(k_img).all() and err == 0 and k_segs == p_segs
            and k_it == p_it and (dev.type != "cuda" or k_n == k_it)):
        raise AssertionError("(a): the one-bounce frame differs between "
                             "the kernel and the plain version")

    w, h, spp, depth = sz["one_bounce"]
    scene, cam = build_final_scene(w / h, device=dev)
    kw = dict(max_depth=depth, window=1, return_stats=True, device=dev,
              tile_rows=sz["tile_rows"])
    torch.cuda.synchronize()
    WB.wave_bounce.launches = 0
    t0 = time.perf_counter()
    with keep_launch() as kept:
        img, segs, iters, lane_steps = render_wq(scene, cam, w, h, spp, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = WB.wave_bounce.launches
    (img2, _, _, _), syncs = count_syncs(
        dev, lambda: render_wq(scene, cam, w, h, spp, **kw))
    frame = img.cpu().numpy()
    bad, worst = envelope(frame, frame8["frame"])
    log(f"[14] (a) one-bounce render_wq final scene {w}x{h}x{spp} depth "
        f"{depth}: {dt:.3f} s, {segs / dt / 1e6:.3f} Mray/s, {segs:.0f} "
        f"segments (windowed, phase 11: {frame8['segs']:.0f}), {iters} "
        f"iterations on {lane_steps / max(iters, 1):.0f} lanes, occupancy "
        f"{segs / lane_steps:.3f}; K1 launches {launches}; host reads "
        f"{iters} (the loop condition, one a bounce), synchronising calls "
        f"in a second run {syncs}; against the windowed frame "
        f"{bad:.4f} of pixels beyond 5e-3, max {worst:.4g}; second run "
        f"bit-equal {torch.equal(img, img2)}")
    if launches != iters or launches == 0:
        raise AssertionError(f"(a): {launches} launches for {iters} "
                             f"iterations")
    if abs(segs - frame8["segs"]) > 0.002 * frame8["segs"]:
        raise AssertionError(f"(a): segments {segs} against the windowed "
                             f"{frame8['segs']}")
    if not torch.equal(img, img2):
        raise AssertionError("(a): two one-bounce renders differ")
    row = check_kept("one-bounce render_wq", kept, tag="14")
    return dict(launches=launches, kept=row, wall_s=dt, segs=segs,
                iters=iters, syncs=syncs)


def _named(tree, prefix=()):
    """(dotted name, leaf) of every non-None leaf of a (scene, camera)
    params tree."""
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", ("scene", "camera"))
        for name, kid in zip(names, tree):
            yield from _named(kid, prefix + (name,))
    elif tree is not None:
        yield ".".join(prefix), tree


def box_pixels(scene, res, n_pix: int, spp: int) -> torch.Tensor:
    """Pixels of the canonical grid any of whose samples' recorded paths
    hit a rect whose scan id several sides share (a box)."""
    r = scene.rects
    box = torch.unique(r.scan[r.active & (r.sub > 0)]).long()
    enc = torch.clamp(res.win - 1.0, min=0.0)
    rem = enc - torch.floor(enc / 4096.0) * 4096.0
    cls = torch.floor(rem / 1024.0)
    scan = (rem - cls * 1024.0).long()
    hit = ((res.win > 0) & (cls == 1.0)
           & torch.isin(scan, box.to(scan.device))).any(0).reshape(-1)
    return hit[:n_pix * spp].reshape(spp, n_pix).any(0)


def phase_pinned(dev, train, sizes=None) -> dict:
    """14 (b), (c). The pinned route at phase 8's setting through
    `make_render_grad(queued=False)`: its launches and lane count, every
    launch of a second recording bit-equal to the plain version, a kept
    launch; then against `make_render_grad(queued=True)` on phase 9's
    perturbed params and target: the forward's envelope, the loss, each
    leaf's gradient, and the same on the loss over the pixels no box
    touches.  Then `render_grad_fn` on a seeded non-canonical list,
    kernel against plain.  `sizes` overrides PHASE14's."""
    from path_tracer_tpu_torch.core.vec import fdiv
    from path_tracer_tpu_torch.diff import params as P
    from path_tracer_tpu_torch.diff.pallas_vjp import (make_render_grad,
                                                       render_grad_fn)
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    from path_tracer_tpu_torch.scene.presets import build_final_scene
    sz = dict(PHASE14, **(sizes or {}))
    w, h, spp, depth = sz["pinned"]
    n = w * h
    scene, cam = build_final_scene(w / h, device=dev)
    pix = torch.arange(n, device=dev).repeat(spp).float()
    samp = torch.arange(spp, device=dev).repeat_interleave(n).float()
    kw = dict(max_depth=depth, device=dev, tile_rows=sz["tile_rows"])
    fp = make_render_grad(w, h, pix, samp, queued=False, **kw)
    fq = make_render_grad(w, h, pix, samp, queued=True, **kw)

    WB.wave_bounce.launches = 0
    WB.wave_bounce.events = [] if dev.type == "cuda" else None
    with keep_launch() as kept, torch.no_grad():
        fp(scene, cam)
    launches, events = WB.wave_bounce.launches, WB.wave_bounce.events
    WB.wave_bounce.events = None
    res = fp.fn.last
    lanes = res.dx[0].numel()
    res_bytes = sum(x.numel() * x.element_size() for x in res)
    widths = sorted({ln for ln, _, _ in events or ()})
    log(f"[14] (b) pinned route {w}x{h}x{spp} depth {depth}: K1 launches "
        f"{launches} at {widths} lanes ({lanes} recorded); residuals "
        f"{res_bytes} B")
    if dev.type == "cuda" and (launches != depth or widths != [lanes]):
        raise AssertionError(f"(b): {launches} launches at {widths}, not "
                             f"{depth} at {lanes}")
    kept_row = check_kept("pinned route", kept, tag="14")
    with check_every_launch("pinned route") as chk, torch.no_grad():
        fp(scene, cam)
    log(f"[14] (b) a second recording: {chk.n} launches, each bit-equal to "
        f"the plain version on its own inputs")
    if chk.n != depth:
        raise AssertionError(f"(b): the checked recording launched {chk.n}")

    def fwd():
        with torch.no_grad():
            fp(scene, cam)

    forward_s = time_host(fwd, 2)
    params, static = P.partition((scene, cam))
    params = perturb_colors(params)
    target = torch.from_numpy(train["target"]).to(dev)
    names = [nm for nm, _ in _named(params)]

    def value_and_grad(f, mask=None):
        xs = [x.detach().requires_grad_(True) for x in P.leaves(params)]
        img = f(*P.combine(P.with_leaves(params, xs), static))
        err = img - target
        if mask is not None:
            err = err * mask[:, None]
        loss = fdiv((err * err).sum(), float(n * 3))
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
        return img.detach(), float(loss.detach()), [
            (torch.zeros_like(x) if g is None else g).double().cpu()
            for x, g in zip(xs, gs)]

    def rel(ga, gb):
        """Each leaf's relative L2 difference (leaves with a norm past
        1e-7), but those the pinned replay detaches."""
        out = {}
        for nm, a, b in zip(names, ga, gb):
            if nm not in PINNED_DETACHED and float(b.norm()) > 1e-7:
                out[nm] = float((a - b).norm()) / float(b.norm())
        return out

    reset_peak(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_p, loss_p, g_p = value_and_grad(fp)
    torch.cuda.synchronize()
    vg_s = time.perf_counter() - t0
    peak = peak_gib(dev)
    img_q, loss_q, g_q = value_and_grad(fq)
    bad, worst = envelope(img_p.cpu().numpy(), img_q.cpu().numpy())
    full = rel(g_p, g_q)
    boxed = box_pixels(scene, fp.fn.last, n, spp)
    mask = (~boxed).float()
    _, loss_pm, g_pm = value_and_grad(fp, mask)
    _, loss_qm, g_qm = value_and_grad(fq, mask)
    masked = rel(g_pm, g_qm)
    top = lambda d: dict(sorted(d.items(), key=lambda x: -x[1])[:6])
    log(json.dumps({
        "config": {"width": w, "height": h, "spp": spp, "depth": depth,
                   "scene": "final", "backend": dev.type,
                   "route": "pallas_vjp (pinned)", "lanes": lanes},
        "forward_s": round(forward_s, 4), "value_and_grad_s": round(vg_s, 4),
        "residual_bytes": res_bytes, "peak_gib": round(peak, 3)}))
    log(f"[14] (b) against the queued route on phase 9's params and "
        f"target: forward {bad:.4f} of pixels beyond 5e-3, max {worst:.4g}; "
        f"loss {loss_p!r} / {loss_q!r}; per-leaf relative L2, worst six: "
        f"{json.dumps(top(full))}; {int(boxed.sum())} of {n} pixels touch "
        f"a box; on the loss over the rest ({loss_pm!r} / {loss_qm!r}), "
        f"worst six: {json.dumps(top(masked))}")
    if abs(loss_p - loss_q) > 1e-5 * abs(loss_q):
        raise AssertionError(f"(b): loss {loss_p} against {loss_q}")
    if any(float(g.abs().sum()) for nm, g in zip(names, g_p)
           if nm in PINNED_DETACHED):
        raise AssertionError(f"(b): the pinned route moved {PINNED_DETACHED}")
    if max(masked.values()) > PINNED_RTOL:
        raise AssertionError(f"(b): off boxes a leaf's gradient is past "
                             f"{PINNED_RTOL}: {top(masked)}")

    # (c): a non-canonical list, kernel against plain
    rs = np.random.RandomState(14)
    pix_c = torch.from_numpy(rs.randint(0, n, sz["pairs"])).float()
    samp_c = torch.from_numpy(rs.randint(0, 64, sz["pairs"])).float()
    try:
        make_render_grad(w, h, pix_c, samp_c, device=dev)
    except ValueError:
        pass
    else:
        raise AssertionError("(c): make_render_grad took a non-canonical "
                             "list")
    outs = {}
    for d in (dev.type, "cpu"):
        s_, c_ = build_final_scene(w / h, device=d)
        g = render_grad_fn(w, h, max_depth=depth, tile_rows=8, device=d)
        p_, st_ = P.partition((s_, c_))
        xs = [x.detach().requires_grad_(True) for x in P.leaves(p_)]
        rad = g(*P.combine(P.with_leaves(p_, xs), st_), pix_c, samp_c)
        gs = torch.autograd.grad(rad.mean(), xs, allow_unused=True)
        outs[d] = (rad.detach().cpu(), [x.cpu() for x in g.last],
                   [(torch.zeros_like(x) if gg is None else gg).double().cpu()
                    for x, gg in zip(xs, gs)])
    (k_rad, k_rec, k_g), (p_rad, p_rec, p_g) = outs[dev.type], outs["cpu"]
    rec_diff = sum(int((a != b).sum()) for a, b in zip(k_rec, p_rec))
    # phase 7's contract: the mean radiance's gradient, each leaf's L2
    # difference over its norm floored at 1e-4
    leaf_c = {nm: float((a - b).norm()) / max(float(b.norm()), 1e-4)
              for nm, a, b in zip(names, k_g, p_g)}
    worst_c = max(leaf_c.values())
    log(f"[14] (c) render_grad_fn on {sz['pairs']} seeded (pixel, sample) "
        f"pairs, depth {depth}: make_render_grad refused the list; kernel "
        f"vs plain: record entries that differ {rec_diff}, radiance equal "
        f"{torch.equal(k_rad, p_rad)}; gradient of the mean radiance, "
        f"relative L2, worst three: "
        f"{json.dumps(dict(sorted(leaf_c.items(), key=lambda x: -x[1])[:3]))}")
    if rec_diff or not torch.equal(k_rad, p_rad) or worst_c > 2e-3:
        raise AssertionError("(c): kernel and plain disagree")
    return dict(launches=launches, kept=kept_row, forward_s=forward_s,
                value_and_grad_s=vg_s, residual_bytes=res_bytes,
                peak_gib=peak, full=full, masked=masked)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-kernel", default=None,
                    help="an earlier csrc/wave_bounce.cu to time beside K1")
    ap.add_argument("--old-pmat", default=None,
                    help="an earlier csrc/spike_pmat.cu whose launch takes "
                         "no K, to time beside K2")
    opts = ap.parse_args()
    rows = main(opts.old_kernel, opts.old_pmat)
    print(json.dumps({"kernels": rows}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
