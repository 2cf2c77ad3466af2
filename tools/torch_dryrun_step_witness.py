"""Does one train step of the distributed dry run lower the loss, on the
reference and on the port, when it updates every leaf?

    JAX_PLATFORMS=cpu python tools/torch_dryrun_step_witness.py [--lr 0.4 0.1]

The setting of `__graft_entry__.dryrun_multichip` (c) and of the port's
`path_tracer_tpu_torch/dryrun.py` (c): the final scene at 32x32, 4 spp,
depth 6, every solid texture colour raised by 20%, the target the
unperturbed frame (the reference's `render_wq`, 128-lane tiles,
window=2).  For each lr and for two gradient filters (every leaf; the
texture colours only) it takes one SGD step and reads the loss at the
updated params:
- the reference: `parallel.mesh.make_train_step` on a 1x1 mesh
  (tile_rows=8, as the dry run), FETCH_MODE "high"; the loss after the step
  comes from the first call of a second step built the same way, since the
  jitted step raises on its second call (ROADMAP Queue 3);
- the port: `parallel.mesh.make_train_step` on the CPU, no mesh, on the
  same scene converted from the reference's arrays.
One line each: who, filter, lr, loss before -> loss after.  The reference
takes ~90 s a (filter, lr) on the CPU, the port ~15 s.
"""
import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from path_tracer_tpu.diff import queued_vjp as JQ
from path_tracer_tpu.engine.wq import render_wq
from path_tracer_tpu.parallel import mesh as JM
from path_tracer_tpu.scene.presets import build_final_scene
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.dryrun import only_texture_colors
from path_tracer_tpu_torch.parallel import mesh as TM

W = H = 32
SPP, DEPTH = 4, 6


def raise_texture_colors(params):
    scene_p, cam_p = params
    tex = scene_p.textures
    c1 = type(tex.c1)(*(c * 1.2 for c in tex.c1))
    return (scene_p._replace(textures=tex._replace(c1=c1)), cam_p)


def jax_only_texture_colors(grads):
    zs, zc = jax.tree_util.tree_map(
        lambda g: jnp.zeros_like(g) if g is not None else None, grads,
        is_leaf=lambda x: x is None)
    return (zs._replace(textures=zs.textures._replace(
        c1=grads[0].textures.c1)), zc)


def reference(js, jc, target, lr, filt):
    params, (s_scene, s_cam) = JM.scene_camera_params(js, jc)
    params = raise_texture_colors(params)
    mesh = JM.make_mesh(1, 1, devices=jax.devices()[:1])
    pix = jnp.arange(W * H, dtype=jnp.uint32)
    tgt = jnp.asarray(target)
    JQ.FETCH_MODE = "high"
    losses = []
    for _ in range(2):
        step = JM.make_train_step(s_scene, s_cam, W, H, SPP, DEPTH, mesh,
                                  lr=lr, tile_rows=8, grad_filter=filt)
        params, loss = step(params, tgt, pix)
        losses.append(float(loss))
    return losses


def port(scene, cam, target, lr, filt):
    params, (s_scene, s_cam) = TM.scene_camera_params(scene, cam)
    params = raise_texture_colors(params)
    step = TM.make_train_step(s_scene, s_cam, W, H, SPP, DEPTH, lr=lr,
                              grad_filter=filt, device="cpu")
    tgt = torch.from_numpy(np.array(target))
    pix = torch.arange(W * H)
    losses = []
    for _ in range(2):
        params, loss = step(params, tgt, pix)
        losses.append(float(loss))
    return losses


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float, nargs="+", default=[0.4])
    opts = ap.parse_args()
    js, jc = build_final_scene(W / H)
    target = np.asarray(render_wq(js, jc, W, H, SPP, max_depth=DEPTH,
                                  tile_rows=1, window=2)).reshape(W * H, 3)
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    cam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jc))
    for lr in opts.lr:
        for name, jfilt, tfilt in (
                ("every leaf", None, None),
                ("texture colours", jax_only_texture_colors,
                 only_texture_colors)):
            for who, fn, args in (("port", port, (scene, cam, target, lr,
                                                  tfilt)),
                                  ("reference", reference,
                                   (js, jc, target, lr, jfilt))):
                t0 = time.perf_counter()
                before, after = fn(*args)
                print(f"{who:9s} {name:15s} lr {lr}: {before!r} -> "
                      f"{after!r} ({'falls' if after < before else 'rises'};"
                      f" {time.perf_counter() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
