"""Multi-device execution on `torch.distributed`: the (tiles, spp) mesh,
the sharded forward render and the distributed SGD step of inverse
rendering.

Mirrors the reference package's `parallel/mesh.py`, whose scaling design
it keeps: pixels are split over the "tiles" axis and samples over the
"spp" axis of a grid of ranks, one process a device.  The scene is small
and every rank holds all of it.  Sample partial sums are summed over the
spp axis; the frame needs no communication until it is assembled
(`parallel.multihost.assemble_image`).  For inverse rendering the loss and
the parameter gradients are summed over tiles and averaged over spp, the
gradient all-reduce.  Where the reference's `shard_map` body runs once a
device, here each rank runs its own shard and the collectives are
explicit.

Without a process group the mesh is 1x1 and every reduction is a no-op,
so the same code runs in one process.  Both of the reference's renderers
are here: the work queue (`renderer="wq"`, the default) and the oracle
engine's (`renderer="jnp"`); and both gradient backends: record and replay
(`backend="queued"`, the default, or "pallas", the reference's name) and
autograd through `trace(differentiable=True)` (`backend="jnp"`), with
the silhouette terms of `diff.edge` (`geometry_edge`) added before the
all-reduce.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..core.camera import Camera
from ..core.device import resolve_device
from ..core.vec import fdiv
from ..diff.params import combine, leaves, partition, tree_map, with_leaves
from ..diff.queued_vjp import T_MIN, render_grad_fb
from ..engine.integrator import (camera_rays, perf_lanes, render_range,
                                 scene_on, trace)
from ..engine.wq import (DEF_TILE_ROWS, DEF_WINDOW, CPU_TILE_ROWS,
                         CPU_WINDOW, MAX_CHUNK, pick_chunk, wq_window_fb)
from ..scene import types as T

AXES = ("tiles", "spp")


@dataclass
class Mesh:
    """This rank's place on a (tiles, spp) grid of ranks, spp the faster
    axis (rank r of the grid has tile r // n_spp and spp r % n_spp), its
    device, and one process group an axis (None without a process group).
    `collective_s` and `collectives` count the wall time (device work
    before it finished first) and the number of the reductions and
    gathers the mesh ran."""
    n_tiles: int
    n_spp: int
    tile: int
    spp: int
    device: torch.device
    tiles_group: Optional[dist.ProcessGroup] = None
    spp_group: Optional[dist.ProcessGroup] = None
    collective_s: float = 0.0
    collectives: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {"tiles": self.n_tiles, "spp": self.n_spp}

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        if axis not in AXES:
            raise ValueError(f"no mesh axis {axis!r}; the axes are {AXES}")
        return self.tiles_group if axis == "tiles" else self.spp_group

    def collective(self, fn: Callable, t: torch.Tensor):
        """fn() timed into `collective_s`; the device finishes the work
        queued before it first, so only the collective is counted."""
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = fn()
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.collective_s += time.perf_counter() - t0
        self.collectives += 1
        return out

    def psum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """t summed over the ranks of `axis`, in place (t itself without a
        process group)."""
        group = self.group(axis)
        if group is not None:
            self.collective(lambda: dist.all_reduce(t, group=group), t)
        return t


def rank_device(device: Union[None, str, torch.device] = None
                ) -> torch.device:
    """The device of this rank: `device` if given, else
    cuda:{LOCAL_RANK % device_count} (raises without CUDA)."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_tiles: Optional[int] = None, n_spp: int = 1,
              group: Optional[dist.ProcessGroup] = None,
              device: Union[None, str, torch.device] = None) -> Mesh:
    """The (tiles, spp) mesh over the ranks of `group` (default: every
    rank), n_tiles = ranks // n_spp unless given; the grid must cover
    them.  Every rank of the default group calls it, since each axis group
    is made with `dist.new_group`, which all of them call for every group.
    Without a process group it is the 1x1 mesh."""
    dev = rank_device(device)
    if not dist.is_initialized():
        if (n_tiles or 1) * n_spp != 1:
            raise ValueError(f"a {n_tiles}x{n_spp} mesh needs a process "
                             f"group; without one the mesh is 1x1")
        return Mesh(1, 1, 0, 0, dev)
    ranks = (list(range(dist.get_world_size())) if group is None
             else dist.get_process_group_ranks(group))
    if n_tiles is None:
        n_tiles = len(ranks) // n_spp
    if n_tiles < 1 or n_tiles * n_spp != len(ranks):
        raise ValueError(f"a {n_tiles}x{n_spp} mesh does not cover the "
                         f"group's {len(ranks)} ranks")
    me = dist.get_rank()
    tiles_group = spp_group = None
    for s in range(n_spp):
        g = dist.new_group([ranks[t * n_spp + s] for t in range(n_tiles)])
        tiles_group = g if me in ranks[s::n_spp] else tiles_group
    for t in range(n_tiles):
        members = ranks[t * n_spp:(t + 1) * n_spp]
        g = dist.new_group(members)
        spp_group = g if me in members else spp_group
    if me not in ranks:
        raise ValueError(f"rank {me} is not in the mesh's group")
    i = ranks.index(me)
    return Mesh(n_tiles, n_spp, i // n_spp, i % n_spp, dev, tiles_group,
                spp_group)


# ---------------------------------------------------------------------------
# Sharded forward render
# ---------------------------------------------------------------------------

def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def shard_plan(width: int, height: int, spp: int, n_tiles: int, n_spp: int,
               tile: int, spp_idx: int) -> Dict[str, int]:
    """The work-queue arguments of the shard (tile, spp_idx), as the
    reference's "wq" renderer sets them (`mesh.py:88-108`): the chunk is
    capped so the spp axis carries at least one chunk a shard, pixels pad
    up to the tiles axis and trailing sample chunks mask off, so any
    (width, height, spp) works."""
    n_pix = width * height
    chunk = pick_chunk(spp, cap=min(MAX_CHUNK, max(1, spp // n_spp)))
    cpp = spp // chunk
    cpp_loc = _ceil_div(cpp, n_spp)
    n_pix_loc = _ceil_div(n_pix, n_tiles)
    pix_base = tile * n_pix_loc
    return dict(chunk=chunk, spp_loc=cpp_loc * chunk, n_pix_loc=n_pix_loc,
                pix_base=pix_base, samp_base=spp_idx * cpp_loc * chunk,
                valid_pix=min(max(n_pix - pix_base, 0), n_pix_loc),
                valid_cpp=min(max(cpp - spp_idx * cpp_loc, 0), cpp_loc))


def render_sharded(scene: T.Scene, cam: Camera, width: int, height: int,
                   spp: int, mesh: Mesh, max_depth: int = 50,
                   attenuate_emission: bool = False, t_min: float = 1e-3,
                   seed: int = 0, renderer: str = "wq",
                   tile_rows: Optional[int] = None,
                   window: Optional[int] = None,
                   return_stats: bool = False):
    """Forward render over the mesh: this rank renders its tile's pixels
    over its share of the samples, the partial sums are summed over the
    spp axis and divided by spp.  Returns this rank's tile of the frame,
    (n_pix_loc, 3), row i for pixel tile * n_pix_loc + i (rows past the
    frame are zero); `parallel.multihost.assemble_image` puts the tiles
    together.

    renderer="wq" (default): the work queue (`engine.wq.wq_window_fb`);
    with `return_stats` also this rank's (traced_segments, bounce_iters,
    lane_steps).  renderer="jnp": the reference's fallback (its
    `mesh.py:122-158`), `trace` with exact spheres on the (pixel, sample)
    streams of samples [spp_idx * local_spp, ...) with local_spp =
    ceil(spp / n_spp), samples past spp left out; the lanes run in
    `render_perf`'s batches (`render_range`), so on a 1x1 mesh the frame
    is `render_perf`'s."""
    if renderer == "jnp":
        if return_stats:
            raise ValueError("return_stats is the work-queue renderer's")
        return _render_sharded_jnp(scene, cam, width, height, spp, mesh,
                                   max_depth, attenuate_emission, t_min,
                                   seed)
    if renderer != "wq":
        raise ValueError(f"unknown renderer {renderer!r}; have 'wq', 'jnp'")
    dev = mesh.device
    cuda = dev.type == "cuda"
    tile_rows = tile_rows or (DEF_TILE_ROWS if cuda else CPU_TILE_ROWS)
    window = window or (DEF_WINDOW if cuda else CPU_WINDOW)
    plan = shard_plan(width, height, spp, mesh.n_tiles, mesh.n_spp,
                      mesh.tile, mesh.spp)
    fb, segs, iters, lane_steps = wq_window_fb(
        scene, cam, width, height, n_pix_loc=plan["n_pix_loc"],
        spp_loc=plan["spp_loc"], chunk=plan["chunk"], window=window,
        max_depth=max_depth, attenuate=attenuate_emission, t_min=t_min,
        tile_rows=tile_rows, seed=seed, device=dev,
        pix_base=plan["pix_base"], samp_base=plan["samp_base"],
        valid_pix=plan["valid_pix"], valid_cpp=plan["valid_cpp"])
    fb = fdiv(mesh.psum(fb.contiguous(), "spp"), float(spp))
    if return_stats:
        return fb, segs, iters, lane_steps
    return fb


def _render_sharded_jnp(scene, cam, width, height, spp, mesh, max_depth,
                        attenuate_emission, t_min, seed):
    dev = mesh.device
    scene = scene_on(scene, dev)
    n_pix = width * height
    n_pix_loc = _ceil_div(n_pix, mesh.n_tiles)
    local_spp = _ceil_div(spp, mesh.n_spp)
    p_lo = mesh.tile * n_pix_loc
    npx = min(max(n_pix - p_lo, 0), n_pix_loc)
    s_lo = mesh.spp * local_spp
    n_s = min(max(spp - s_lo, 0), local_spp)
    acc = torch.zeros((n_pix_loc, 3), dtype=torch.float32, device=dev)
    if npx and n_s:
        acc[:npx] = render_range(scene, cam, width, height, p_lo, npx, s_lo,
                                 n_s, max_depth, attenuate_emission, t_min,
                                 seed)
    return fdiv(mesh.psum(acc, "spp"), float(spp))


# ---------------------------------------------------------------------------
# Distributed differentiable training step (inverse rendering)
# ---------------------------------------------------------------------------

def make_train_step(static_scene, static_cam_tree, width: int, height: int,
                    local_spp: int, max_depth: int, lr: float = 0.05,
                    grad_filter: Optional[Callable] = None,
                    device: Union[str, torch.device] = "cuda",
                    mesh: Optional[Mesh] = None, backend: str = "queued",
                    geometry_edge=None, edge_kwargs: Optional[dict] = None):
    """Build an SGD step for inverse rendering: step(params, target,
    pix_ids) -> (params', loss).

    params: the float-partitioned (scene, camera) tree
    (`scene_camera_params`); target: the (npx, 3) image of the pixels
    `pix_ids`, which must be a contiguous range (the canonical arange);
    loss = sum((img - target)^2) / (W*H*3), the reference's mean over the
    global pixel population.

    backend="queued" (default), or "pallas", the reference's name for it:
    the gradients come from the record-and-replay route
    (`diff.queued_vjp.render_grad_fb`).  backend="jnp": autograd through
    `trace(differentiable=True)` with attenuated emission, the oracle that
    tests/test_grad.py holds the other route against.  Both routes trace
    with the reference's ray epsilon, `queued_vjp.T_MIN`.

    geometry_edge: sphere indices whose centre (c0) and radius gradients
    get the silhouette term of `diff.edge.sphere_silhouette_grad`, each
    rank against its own pixels' loss cotangent 2*err/(W*H*3), added
    before the all-reduce so that the tiles' sum assembles the whole
    film's integral; `edge_kwargs` go to it (n_edge, spp_edge, ...).

    Without a mesh the step runs on `device`, every pixel in one process.
    With one it runs on the mesh's device: each rank takes its tile's
    contiguous slice of pix_ids and target (npx must divide by the tiles
    axis, as under the reference's shard_map) and samples [spp *
    local_spp, (spp + 1) * local_spp) of them; the loss and the gradients
    are summed over tiles and averaged over spp before `grad_filter` (which
    maps the gradient tree, None at static leaves) and the update p -
    lr*g, so every rank ends with the same params."""
    if backend not in ("queued", "pallas", "jnp"):
        raise ValueError(f"unknown backend {backend!r}; have 'queued', "
                         f"'pallas' (the same route), 'jnp'")
    if mesh is not None:
        device = mesh.device
    device = resolve_device(device)
    grad_f_cache: Dict[int, object] = {}

    def get_grad_f(npx: int):
        if npx not in grad_f_cache:
            grad_f_cache[npx] = render_grad_fb(
                width, height, npx, local_spp, max_depth=max_depth,
                device=device)
        return grad_f_cache[npx]

    def render_jnp(scene_, cam_, pix_ids, samp_base):
        npx = pix_ids.shape[0]
        lanes_pix, _, state = perf_lanes(pix_ids.to(device).long(),
                                         samp_base, local_spp, 0)
        state, o, d, t = camera_rays(cam_, width, height, lanes_pix, state)
        _, rad = trace(scene_on(scene_, device), o, d, t, state, max_depth,
                       attenuate_emission=True, t_min=T_MIN,
                       differentiable=True)
        return torch.stack([c.reshape(local_spp, npx).mean(0) for c in rad],
                           dim=-1)

    def edge_terms(scene_, cam_, err, pix_ids, grads):
        """The silhouette terms of the configured spheres against this
        rank's loss cotangent dL/dimg = 2*err/(W*H*3)."""
        from ..diff.edge import sphere_silhouette_grad
        ct = torch.zeros((width * height, 3), dtype=torch.float32,
                         device=device)
        ct[pix_ids.to(device).long()] = fdiv(2.0 * err.detach(),
                                             float(width * height * 3))
        ct = ct.reshape(height, width, 3)
        scene_g, cam_g = grads
        sph = scene_g.spheres
        c0x, c0y, c0z, rad = (x.clone() for x in (*sph.c0, sph.radius))
        for si in geometry_edge:
            eg = sphere_silhouette_grad(scene_on(scene_, device), cam_,
                                        width, height, int(si), ct,
                                        **dict(edge_kwargs or {}))
            for g, e in zip((c0x, c0y, c0z, rad), (*eg.center, eg.radius)):
                g[int(si)] += e.to(g.device)
        sph = sph._replace(c0=type(sph.c0)(c0x, c0y, c0z), radius=rad)
        return (scene_g._replace(spheres=sph), cam_g)

    def step(params, target: torch.Tensor, pix_ids: torch.Tensor
             ) -> Tuple[object, torch.Tensor]:
        samp_base = 0
        if mesh is not None:
            n = pix_ids.shape[0]
            if n % mesh.n_tiles:
                raise ValueError(f"{n} pixels do not split evenly over "
                                 f"{mesh.n_tiles} tiles")
            sl = slice(mesh.tile * (n // mesh.n_tiles),
                       (mesh.tile + 1) * (n // mesh.n_tiles))
            pix_ids, target = pix_ids[sl], target[sl]
            samp_base = mesh.spp * local_spp
        xs = [p.detach().requires_grad_(True) for p in leaves(params)]
        scene_, cam_ = combine(with_leaves(params, xs),
                               (static_scene, static_cam_tree))
        npx = pix_ids.shape[0]
        if backend == "jnp":
            img = render_jnp(scene_, cam_, pix_ids, samp_base)
        else:
            img = get_grad_f(npx)(scene_, cam_, int(pix_ids[0]), samp_base)
        err = img - target
        loss = fdiv((err * err).sum(), float(width * height * 3))
        # a leaf the render never reads (the jnp trace reads fewer than
        # the replay) has a zero gradient, as under jax.grad
        gs = [torch.zeros_like(x) if g is None else g for x, g in zip(
            xs, torch.autograd.grad(loss, xs, allow_unused=True))]
        loss = loss.detach()
        if geometry_edge:
            gs = leaves(edge_terms(scene_, cam_, err, pix_ids,
                                   with_leaves(params, list(gs))))
        if mesh is not None:
            # tiles sum partial pixel populations; spp averages independent
            # Monte-Carlo estimates of the same gradient: one flat buffer on
            # the mesh's device (the camera's leaves live on the CPU), one
            # reduction an axis
            flat = torch.cat([loss.reshape(1).to(device)]
                             + [g.reshape(-1).to(device) for g in gs])
            flat = fdiv(mesh.psum(mesh.psum(flat, "tiles"), "spp"),
                        float(mesh.n_spp))
            loss = flat[0]
            sizes = [g.numel() for g in gs]
            gs = [part.reshape(g.shape).to(g.device) for part, g in zip(
                torch.split(flat[1:], sizes), gs)]
        grads = with_leaves(params, list(gs))
        if grad_filter is not None:
            grads = grad_filter(grads)
        new = tree_map(lambda p, g: None if p is None else p.detach() - lr * g,
                       params, grads)
        return new, loss

    return step


def scene_camera_params(scene: T.Scene, cam: Camera):
    """Partition (scene, camera) into differentiable params + statics."""
    return partition((scene, cam))
