"""A distributed dry run of the port on n ranks.

    python -m path_tracer_tpu_torch.dryrun 2            # n ranks, the GPUs
    python -m path_tracer_tpu_torch.dryrun 2 --device cpu

The counterpart of the reference's `__graft_entry__.dryrun_multichip`.
`dryrun_multichip(n)` starts n ranks (`parallel.launch.spawn`: NCCL when
each rank has a card of its own, gloo on the CPU or when ranks share a
card) on an (n/2 x 2) mesh for even n >= 4, else (n x 1), and runs the
final scene (every hittable class, media, image textures, the emission
quirk) at 32x32, 4 spp, depth 6:

(a) `render_sharded` with 128-lane tiles, so that each rank's shard
    spans several tiles and the drain stages compact it, and window=2,
    so several deposit windows end; the assembled frame against one
    `render_wq` of the whole frame, max abs error under 1e-4;
(b) the gradient route's recording forward: it must drain, and
    image-texture fixups must cross the texel service;
(c) two sharded train steps from every solid texture colour raised by
    20%, toward the frame of (a), lr 0.4, on the texture colours only:
    the loss must be finite and fall.  The reference's step updates every
    leaf (and its jitted step fails on its second call); one step on every
    leaf raises this loss on the reference as on the port, at lr 0.4 and
    0.1 (tools/torch_dryrun_step_witness.py).
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

W = H = 32
SPP, DEPTH = 4, 6
TILE_ROWS = 1     # 128-lane tiles: each shard spans >= 2, so drains engage
WINDOW = 2
LR = 0.4


def only_texture_colors(grads):
    """The gradient tree with every leaf but the texture colours zeroed:
    the perturbed leaves.  The interior estimator sees no visibility
    motion, so geometry gradients wander at this spp (the reference's
    tests/test_sharding.py filters its step for the same reason)."""
    from .diff.params import tree_map
    zs, zc = tree_map(lambda g: None if g is None else torch.zeros_like(g),
                      grads)
    return (zs._replace(textures=zs.textures._replace(
        c1=grads[0].textures.c1)), zc)


def dryrun_rank(device: str) -> Dict:
    """One rank's part of the dry run (inside a process group)."""
    import torch.distributed as dist
    from .diff import queued_vjp as Q
    from .engine.wq import render_wq
    from .ops import wave_bounce as WB
    from .parallel.mesh import (make_train_step, render_sharded,
                                scene_camera_params)
    from .parallel.multihost import assemble_image, global_mesh
    from .scene.presets import build_final_scene

    world = dist.get_world_size() if dist.is_initialized() else 1
    n_spp = 2 if world % 2 == 0 and world >= 4 else 1    # the reference's
    mesh = global_mesh(n_spp, device=None if device == "cuda" else device)
    dev = mesh.device
    scene, cam = build_final_scene(W / H, device=dev)
    WB.wave_bounce.launches = 0

    # (a) the sharded render against the whole frame's
    fb = render_sharded(scene, cam, W, H, SPP, mesh, max_depth=DEPTH,
                        tile_rows=TILE_ROWS, window=WINDOW)
    frame = assemble_image(fb, mesh, W, H)
    single = render_wq(scene, cam, W, H, SPP, max_depth=DEPTH,
                       tile_rows=TILE_ROWS, window=WINDOW, device=dev)
    err = float(np.abs(frame - single.cpu().numpy()).max())

    # (b) the recording forward crosses the texel service
    f = Q.render_grad_fb(W, H, W * H, SPP, max_depth=DEPTH, device=dev)
    rcfg = {k: v for k, v in f.cfg.items() if k not in ("width", "height")}
    _, rec, ok = Q.record_forward_q(scene, cam, W, H, 0, 0, **rcfg)
    n_fix = int((rec.a.fixk > 0).sum() + (rec.b.fixk > 0).sum())

    # (c) two sharded train steps
    params, (s_scene, s_cam) = scene_camera_params(scene, cam)
    scene_p, cam_p = params
    tex = scene_p.textures
    params = (scene_p._replace(textures=tex._replace(c1=type(tex.c1)(
        *(c * 1.2 for c in tex.c1)))), cam_p)
    step = make_train_step(s_scene, s_cam, W, H, max(SPP // n_spp, 1),
                           DEPTH, lr=LR, grad_filter=only_texture_colors,
                           mesh=mesh)
    target = torch.from_numpy(frame.reshape(W * H, 3)).to(dev)
    pix = torch.arange(W * H, device=dev)
    losses = []
    for _ in range(2):
        params, loss = step(params, target, pix)
        losses.append(float(loss))
    return dict(mesh=(mesh.n_tiles, mesh.n_spp), err=err, ok=bool(ok), n_fix=n_fix,
                losses=losses, launches=WB.wave_bounce.launches)


def dryrun_multichip(n: int, device: str = "cuda") -> Dict:
    """The dry run on n ranks; raises if a check fails, else prints one
    line and returns rank 0's results (K1's `launches` counts the
    kernel's launches on the rank, 0 on the CPU)."""
    from .parallel import launch
    res = launch.spawn(dryrun_rank, n, (device,), device=device)
    r = res[0]
    losses = r["losses"]
    if not all(x["losses"] == losses for x in res):
        raise AssertionError(f"the ranks' losses differ: {res}")
    if not r["err"] < 1e-4:
        raise AssertionError(f"sharded vs single-device mismatch: {r['err']}")
    if not r["ok"]:
        raise AssertionError("the recording queue did not drain")
    if not r["n_fix"] > 0:
        raise AssertionError("no image-texture fixups crossed the texel "
                             "service")
    if not (np.isfinite(losses).all() and losses[1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")
    if device == "cuda" and not all(x["launches"] > 0 for x in res):
        raise AssertionError(f"a rank launched no bounce kernel: {res}")
    print(f"dryrun_multichip({n}): mesh={r['mesh'][0]}x{r['mesh'][1]} "
          f"final scene {W}x{H}x{SPP}spp on {device}: wq (drain + windows) "
          f"max|err|={r['err']:.2e}, texel fixups {r['n_fix']}, train "
          f"{losses[0]:.6f} -> {losses[1]:.6f} OK", flush=True)
    return r


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    opts = ap.parse_args()
    dryrun_multichip(opts.n, opts.device)
