"""The differentiable training step (inverse rendering), on one device.

Mirrors `make_train_step` and `scene_camera_params` of the reference
package's `parallel/mesh.py` on a 1x1 (tiles, spp) mesh: one process
renders every pixel of the frame with the record-and-replay gradient
route (`diff.queued_vjp.render_grad_fb`), takes the loss of the
reference's `local_loss`, filters the gradients and applies SGD.  The
all-reduce of gradients over tiles and samples across devices, the
silhouette terms (`geometry_edge`) and the jnp backend are not ported
yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ..core.camera import Camera
from ..core.vec import fdiv
from ..diff.params import combine, leaves, partition, tree_map, with_leaves
from ..diff.queued_vjp import render_grad_fb
from ..scene import types as T


def make_train_step(static_scene, static_cam_tree, width: int, height: int,
                    local_spp: int, max_depth: int, lr: float = 0.05,
                    grad_filter: Optional[Callable] = None,
                    device: Union[str, torch.device] = "cuda"):
    """Build an SGD step for inverse rendering: step(params, target,
    pix_ids) -> (params', loss).

    params: the float-partitioned (scene, camera) tree
    (`scene_camera_params`); target: the (npx, 3) image of the pixels
    `pix_ids`, which must be a contiguous range (the canonical arange);
    loss = sum((img - target)^2) / (W*H*3), the reference's mean over the
    global pixel population.  `grad_filter` maps the gradient tree (None
    at static leaves) before the update p - lr*g.  The gradients come
    from the record-and-replay route, the reference's "pallas" backend;
    its "jnp" backend is not ported."""
    grad_f_cache: Dict[int, object] = {}

    def get_grad_f(npx: int):
        if npx not in grad_f_cache:
            grad_f_cache[npx] = render_grad_fb(
                width, height, npx, local_spp, max_depth=max_depth,
                device=device)
        return grad_f_cache[npx]

    def step(params, target: torch.Tensor, pix_ids: torch.Tensor
             ) -> Tuple[object, torch.Tensor]:
        xs = [p.detach().requires_grad_(True) for p in leaves(params)]
        scene_, cam_ = combine(with_leaves(params, xs),
                               (static_scene, static_cam_tree))
        npx = pix_ids.shape[0]
        img = get_grad_f(npx)(scene_, cam_, int(pix_ids[0]), 0)
        err = img - target
        loss = fdiv((err * err).sum(), float(width * height * 3))
        gs = torch.autograd.grad(loss, xs)
        grads = with_leaves(params, list(gs))
        if grad_filter is not None:
            grads = grad_filter(grads)
        new = tree_map(lambda p, g: None if p is None else p.detach() - lr * g,
                       params, grads)
        return new, loss.detach()

    return step


def scene_camera_params(scene: T.Scene, cam: Camera):
    """Partition (scene, camera) into differentiable params + statics."""
    return partition((scene, cam))
