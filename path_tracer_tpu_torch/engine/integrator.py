"""Wavefront path-tracing integrator: camera rays, and the oracle and
parity engines built on `intersect_scene` and `scatter`.

Mirrors the reference package's `engine/integrator.py`.  The reference
integrates each pixel with nested sequential loops, samples over bounces
over primitives (render.hpp:25-106); here the whole ray batch advances
through the bounce loop together, with per-lane alive masks.  Path ends:

* miss -> radiance += throughput * sky gradient (render.hpp:83-87);
* a hit on a non-scattering material -> radiance += emitted, NOT times
  the throughput in the reference (render.hpp:73, a physics quirk);
  `attenuate_emission=True` gives the physically correct alternative;
* depth exhausted -> black (render.hpp:91).

Two loop flavours, as the reference's: `trace(differentiable=False)` is a
host loop that stops when no lane is alive (one `.any().item()` a bounce,
a host sync the oracle can afford); `trace(differentiable=True)` runs
max_depth bounces, each under `torch.utils.checkpoint`, which stands in
for `jax.checkpoint` (per-bounce rematerialization).

Two seeding modes: parity (`render_parity`: per-pixel streams seeded with
the pixel id, samples in sequence, the reference's streams) and perf
(`render_perf`, `render_fused`, `render_wavefront`: counter-seeded
(pixel, sample) streams, so samples run in parallel and tiles stream).
These are torch ops on the scene's device; the production renderer is
`engine.wq.render_wq`, which these engines are the yardstick of.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..core import rng as rng_mod
from ..core.camera import Camera
from ..core.device import resolve_device
from ..core.rng import f32
from ..core.vec import Vec3, fdiv, unit_vector, where as vwhere
from ..diff.params import tree_map
from ..scene import types as T
from .intersect import Hit, intersect_scene
from .scatter import scatter

SKY_TOP = (0.5, 0.7, 1.0)

Device = Union[str, torch.device]


class PathState(NamedTuple):
    o: Vec3
    d: Vec3
    time: torch.Tensor
    rng: torch.Tensor
    throughput: Vec3
    radiance: Vec3
    alive: torch.Tensor


def scene_on(scene: T.Scene, device: torch.device) -> T.Scene:
    """The scene with every tensor on `device` (the same tensors, and so
    the same autograd leaves, where they are there already)."""
    return tree_map(lambda x: None if x is None else x.to(device), scene)


def _bounce(scene: T.Scene, state: PathState, attenuate_emission: bool,
            t_min: float, exact: bool = True) -> PathState:
    rng, hit = intersect_scene(scene, state.o, state.d, state.time,
                               state.rng, state.alive, t_min, exact)
    return _shade(scene, state, rng, hit, attenuate_emission)


def _shade(scene: T.Scene, state: PathState, rng: torch.Tensor, hit: Hit,
           attenuate_emission: bool) -> PathState:
    """The rest of a bounce after the intersection: sky, scatter,
    emission and the next ray."""
    o, d, time, _, tp, rad, alive = state

    # miss -> sky gradient times the throughput (render.hpp:83-87)
    miss = alive & ~hit.hit
    ud = unit_vector(d)
    sky_t = 0.5 * (ud.y + 1.0)
    sky = Vec3(*((1.0 - sky_t) + f32(c) * sky_t for c in SKY_TOP))
    zero = torch.zeros_like(sky_t)
    zero3 = Vec3(zero, zero, zero)
    rad = rad + vwhere(miss, tp * sky, zero3)

    # hit -> scatter
    sc_mask = alive & hit.hit
    rng, sc = scatter(scene, hit, d, rng, sc_mask)

    # non-scattering hit -> emitted (unattenuated in reference mode)
    stop_emit = sc_mask & ~sc.did_scatter
    emit = tp * sc.emitted if attenuate_emission else sc.emitted
    rad = rad + vwhere(stop_emit, emit, zero3)

    cont = sc_mask & sc.did_scatter
    tp = vwhere(cont, tp * sc.attenuation, tp)
    o = vwhere(cont, hit.p, o)
    d = vwhere(cont, sc.direction, d)
    return PathState(o, d, time, rng, tp, rad, cont)


def trace(scene: T.Scene, o: Vec3, d: Vec3, time: torch.Tensor,
          rng_state: torch.Tensor, max_depth: int,
          attenuate_emission: bool = False, t_min: float = 1e-3,
          differentiable: bool = False, exact: bool = True
          ) -> Tuple[torch.Tensor, Vec3]:
    """Trace a batch of camera rays to the end, get_color (render.hpp:29-92)
    over the whole batch, on the rays' device.  Returns (rng', radiance).

    differentiable=False: a host loop of at most max_depth bounces that
    stops once no lane is alive (one host sync a bounce).
    differentiable=True: exactly max_depth bounces, each recomputed in the
    backward pass (`torch.utils.checkpoint`, non-reentrant), so the
    residual memory grows by one bounce's carry a bounce."""
    zero = torch.zeros_like(o.x)
    one = torch.ones_like(o.x)
    st = PathState(o=o, d=d, time=time, rng=rng_state,
                   throughput=Vec3(one, one, one),
                   radiance=Vec3(zero, zero, zero),
                   alive=torch.ones_like(o.x, dtype=torch.bool))
    if differentiable:
        def body(*flat):
            nxt = _bounce(scene, _unflatten(flat), attenuate_emission, t_min,
                          exact)
            return _flatten(nxt)

        for _ in range(max_depth):
            st = _unflatten(checkpoint(body, *_flatten(st),
                                       use_reentrant=False,
                                       preserve_rng_state=False))
    else:
        for _ in range(max_depth):
            if not bool(st.alive.any()):
                break
            st = _bounce(scene, st, attenuate_emission, t_min, exact)
    return st.rng, st.radiance


def _flatten(st: PathState) -> tuple:
    return (*st.o, *st.d, st.time, st.rng, *st.throughput, *st.radiance,
            st.alive)


def _unflatten(f) -> PathState:
    return PathState(Vec3(*f[0:3]), Vec3(*f[3:6]), f[6], f[7],
                     Vec3(*f[8:11]), Vec3(*f[11:14]), f[14])


# ---------------------------------------------------------------------------
# Camera ray generation
# ---------------------------------------------------------------------------

def camera_rays(cam: Camera, width: int, height: int,
                pix_ids: torch.Tensor, rng_state: torch.Tensor
                ) -> Tuple[torch.Tensor, Vec3, Vec3, torch.Tensor]:
    """Jittered primary rays for flat int64 pixel ids (linear = y*W + x,
    y bottom-up like the reference fb).  5 draws a lane: u, v jitter,
    then get_ray's disk (2) and time (1) — render.hpp:96-99."""
    x = (pix_ids % width).to(torch.float32)
    y = torch.div(pix_ids, width, rounding_mode="floor").to(torch.float32)
    rng_state, ju = rng_mod.next_f01(rng_state)
    rng_state, jv = rng_mod.next_f01(rng_state)
    u = fdiv(x + ju, float(width))
    v = fdiv(y + jv, float(height))
    return cam.get_ray(u, v, rng_state)


def _stack3(v: Vec3) -> torch.Tensor:
    return torch.stack([v.x, v.y, v.z], dim=-1)


# ---------------------------------------------------------------------------
# Parity-mode renderer (sequential samples, the reference's RNG streams)
# ---------------------------------------------------------------------------

def _render_parity_band(scene, cam, width, height, spp, max_depth,
                        attenuate_emission, t_min, pix_start, n, dev):
    pix_ids = pix_start + torch.arange(n, dtype=torch.int64, device=dev)
    rng = rng_mod.seed_parity(pix_ids)
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    acc = Vec3(zero, zero, zero)
    for _ in range(spp):
        rng, o, d, t = camera_rays(cam, width, height, pix_ids, rng)
        rng, rad = trace(scene, o, d, t, rng, max_depth, attenuate_emission,
                         t_min, differentiable=False)
        acc = acc + rad
    return fdiv(_stack3(acc), float(spp))


def render_parity(scene: T.Scene, cam: Camera, width: int, height: int,
                  spp: int, max_depth: int = 50,
                  attenuate_emission: bool = False, t_min: float = 1e-3,
                  band_rows: int = 0, device: Device = "cuda"
                  ) -> torch.Tensor:
    """Render with the reference's exact RNG streams: pixel i seeded with
    i, its samples in sequence (render.hpp:126-136).  Output (H, W, 3) on
    `device`, fb row 0 = image bottom.

    `band_rows` > 0 renders horizontal bands of that many pixel rows, one
    after another: the (lanes, primitives) intermediates of the fold are
    large (the reference measured ~1.5 GB per 100K lanes on the final
    scene).  Streams are per pixel, so banding is bit-exact."""
    dev = resolve_device(device)
    scene = scene_on(scene, dev)
    n_pix = width * height
    step = band_rows * width if band_rows > 0 else n_pix
    bands = [_render_parity_band(scene, cam, width, height, spp, max_depth,
                                 attenuate_emission, t_min, p0,
                                 min(step, n_pix - p0), dev)
             for p0 in range(0, n_pix, step)]
    return torch.cat(bands).reshape(height, width, 3)


# ---------------------------------------------------------------------------
# Perf-mode renderers (sample-parallel lanes)
# ---------------------------------------------------------------------------

def perf_lanes(pix: torch.Tensor, s0: int, spp_chunk: int, seed: int):
    """Lanes (pixel-major within each sample) of spp_chunk samples from
    s0 for the pixels `pix`, and their counter-seeded streams.  The seed
    goes inside the hash (a post-hash xor only moves low bits, which the
    float draw cannot see for ~20 steps)."""
    n = pix.shape[0]
    lanes_pix = pix.repeat(spp_chunk)
    samp = s0 + torch.arange(spp_chunk, dtype=torch.int64,
                             device=pix.device).repeat_interleave(n)
    return lanes_pix, samp, rng_mod.seed_perf(lanes_pix, samp, seed)


def render_chunk(scene: T.Scene, cam: Camera, width: int, height: int,
                 spp_chunk: int, max_depth: int, attenuate_emission: bool,
                 t_min: float, differentiable: bool, pix_start: int,
                 n_pix: int, samp_start: int, seed: int) -> Vec3:
    """Radiance sums over samples [samp_start, samp_start + spp_chunk) of
    pixels [pix_start, pix_start + n_pix), on the scene's device: one
    batch of n_pix * spp_chunk lanes through `trace` (exact spheres)."""
    dev = scene.spheres.radius.device
    pix = pix_start + torch.arange(n_pix, dtype=torch.int64, device=dev)
    lanes_pix, _, state = perf_lanes(pix, samp_start, spp_chunk, seed)
    state, o, d, t = camera_rays(cam, width, height, lanes_pix, state)
    _, rad = trace(scene, o, d, t, state, max_depth, attenuate_emission,
                   t_min, differentiable=differentiable)
    return Vec3(*(c.reshape(spp_chunk, n_pix).sum(0) for c in rad))


def perf_schedule(n_pix: int, spp: int, max_lanes: int = 1 << 17
                  ) -> Tuple[int, int]:
    """(spp_chunk, tile_pix) of the chunked renderers under a lane
    budget, as the reference chooses them."""
    spp_chunk = max(1, min(spp, max_lanes // min(n_pix, max_lanes)))
    return spp_chunk, max(1, min(n_pix, max_lanes // spp_chunk))


def render_range(scene: T.Scene, cam: Camera, width: int, height: int,
                 pix_start: int, n_pix: int, samp_start: int, n_samp: int,
                 max_depth: int, attenuate_emission: bool, t_min: float,
                 seed: int, max_lanes: int = 1 << 17,
                 differentiable: bool = False) -> torch.Tensor:
    """Radiance sums (n_pix, 3) over samples [samp_start, samp_start +
    n_samp) of pixels [pix_start, pix_start + n_pix), on the scene's
    device: pixel tiles by sample chunks of at most `max_lanes` lanes
    (`perf_schedule`), one `render_chunk` each, the chunks of a tile added
    in sample order."""
    spp_chunk, tile_pix = perf_schedule(n_pix, n_samp, max_lanes)
    tiles = []
    for p0 in range(0, n_pix, tile_pix):
        npx = min(tile_pix, n_pix - p0)
        acc = None
        for s0 in range(0, n_samp, spp_chunk):
            part = render_chunk(scene, cam, width, height,
                                min(spp_chunk, n_samp - s0), max_depth,
                                attenuate_emission, t_min, differentiable,
                                pix_start + p0, npx, samp_start + s0, seed)
            acc = part if acc is None else acc + part
        tiles.append(_stack3(acc))
    return torch.cat(tiles)


def render_perf(scene: T.Scene, cam: Camera, width: int, height: int,
                spp: int, max_depth: int = 50,
                attenuate_emission: bool = False, t_min: float = 1e-3,
                seed: int = 0, max_lanes: int = 1 << 17,
                differentiable: bool = False, device: Device = "cuda"
                ) -> torch.Tensor:
    """Chunked sample-parallel render (`render_range` over the frame), one
    host loop.  Output (H, W, 3) on `device`, fb row 0 = image bottom
    (flipped at save, main.cpp:41)."""
    dev = resolve_device(device)
    fb = render_range(scene_on(scene, dev), cam, width, height, 0,
                      width * height, 0, spp, max_depth, attenuate_emission,
                      t_min, seed, max_lanes, differentiable)
    return fdiv(fb, float(spp)).reshape(height, width, 3)


def render_fused(scene: T.Scene, cam: Camera, width: int, height: int,
                 spp: int, max_depth: int = 50,
                 attenuate_emission: bool = False, t_min: float = 1e-3,
                 seed: int = 0, tile_pix: int = 16384, spp_chunk: int = 4,
                 device: Device = "cuda") -> torch.Tensor:
    """The reference's single-dispatch renderer as a host loop over
    (pixel tile, sample chunk) wavefronts of tile_pix * spp_chunk lanes;
    the last tile traces off-frame pixels, sliced away, and samples past
    spp are weighted 0.  Output (H, W, 3) on `device`."""
    dev = resolve_device(device)
    scene = scene_on(scene, dev)
    n_pix = width * height
    tile_pix = min(tile_pix, n_pix)
    spp_chunk = min(spp_chunk, spp)
    n_tiles = -(-n_pix // tile_pix)
    n_s = -(-spp // spp_chunk)
    fb = torch.zeros((3, n_tiles * tile_pix), dtype=torch.float32,
                     device=dev)
    for k in range(n_tiles * n_s):
        p0 = (k // n_s) * tile_pix
        pix = p0 + torch.arange(tile_pix, dtype=torch.int64, device=dev)
        lanes_pix, samp, state = perf_lanes(pix, (k % n_s) * spp_chunk,
                                             spp_chunk, seed)
        state, o, d, t = camera_rays(cam, width, height, lanes_pix, state)
        _, rad = trace(scene, o, d, t, state, max_depth, attenuate_emission,
                       t_min)
        w = (samp < spp).to(torch.float32)
        part = torch.stack([(c * w).reshape(spp_chunk, tile_pix).sum(0)
                            for c in rad])
        fb[:, p0:p0 + tile_pix] = fb[:, p0:p0 + tile_pix] + part
    fb = fdiv(fb[:, :n_pix], float(spp))
    return fb.T.reshape(height, width, 3)


def wavefront_tiling(n_pix: int, spp: int, device: torch.device,
                     tile_pix: Optional[int] = None,
                     slots: Optional[int] = None) -> Tuple[int, int]:
    """(tile_pix, slots) of `render_wavefront`.  The reference asks
    whether it runs on the TPU; the port asks whether the device is CUDA:
    there a tile is the whole frame rounded up to 256 (at most 1<<19
    pixels) and a pixel has one lane; on the CPU 16,384 pixels, 4 lanes
    each."""
    cuda = device.type == "cuda"
    if tile_pix is None:
        tile_pix = min(-(-n_pix // 256) * 256, 1 << 19) if cuda else 16384
    if slots is None:
        slots = 1 if cuda else 4
    return (min(tile_pix, -(-n_pix // 256) * 256),
            max(1, min(slots, spp)))


def render_wavefront(scene: T.Scene, cam: Camera, width: int, height: int,
                     spp: int, max_depth: int = 50,
                     attenuate_emission: bool = False, t_min: float = 1e-3,
                     seed: int = 0, tile_pix: Optional[int] = None,
                     slots: Optional[int] = None,
                     return_segments: bool = False,
                     return_stats: bool = False, device: Device = "cuda"):
    """The regenerating wavefront renderer, the oracle the work-queue
    renderer is anchored to (tests/test_torch_wq.py).  Lanes are pinned
    to pixels, `slots` a pixel; a lane whose path ends starts its pixel's
    next sample (j, j + slots, ...), each (pixel, sample) on its own
    counter-seeded stream, so the order of regeneration does not change
    the image.  Spheres take the factorized kernel (exact=False).  A host
    loop over tiles and, within each, over bounces until no lane is alive
    (one host sync a bounce).

    Output (H, W, 3) on `device` (+ the traced segment count with
    return_segments; return_stats returns (img, {"segments", "iters",
    "lanes", "tiles"}) instead).  The segment count is an exact integer
    (the reference sums it in float32)."""
    dev = resolve_device(device)
    scene = scene_on(scene, dev)
    n_pix = width * height
    tile_pix, slots = wavefront_tiling(n_pix, spp, dev, tile_pix, slots)
    n_tiles = -(-n_pix // tile_pix)
    n_lanes = tile_pix * slots
    i64 = torch.int64
    pix_local = torch.arange(tile_pix, dtype=i64, device=dev).repeat(slots)
    slot_id = torch.arange(slots, dtype=i64,
                           device=dev).repeat_interleave(tile_pix)

    def start_paths(pix, s, mask, st: PathState) -> PathState:
        """(Re)start camera paths on the masked lanes."""
        state = rng_mod.seed_perf(pix, s, seed)
        state, o, d, t = camera_rays(cam, width, height, pix, state)
        sel = lambda a, b: torch.where(mask, a, b)
        one = torch.ones_like(o.x)
        zero = torch.zeros_like(o.x)
        return PathState(
            o=vwhere(mask, o, st.o), d=vwhere(mask, d, st.d),
            time=sel(t, st.time), rng=sel(state, st.rng),
            throughput=vwhere(mask, Vec3(one, one, one), st.throughput),
            radiance=vwhere(mask, Vec3(zero, zero, zero), st.radiance),
            alive=mask | st.alive)

    fb = torch.zeros((3, n_tiles * tile_pix), dtype=torch.float32,
                     device=dev)
    segments = torch.zeros((), dtype=i64, device=dev)
    iters = 0
    for tile_idx in range(n_tiles):
        pix = tile_idx * tile_pix + pix_local
        s = slot_id
        z = torch.zeros(n_lanes, dtype=torch.float32, device=dev)
        dummy = PathState(Vec3(z, z, z), Vec3(z, z, z), z,
                          torch.zeros(n_lanes, dtype=i64, device=dev),
                          Vec3(z, z, z), Vec3(z, z, z),
                          torch.zeros(n_lanes, dtype=torch.bool, device=dev))
        path = start_paths(pix, s, s < spp, dummy)
        bounces = torch.zeros(n_lanes, dtype=i64, device=dev)
        acc = Vec3(z, z, z)
        while bool(path.alive.any()):
            segments = segments + path.alive.sum()
            was_alive = path.alive
            st = _bounce(scene, path, attenuate_emission, t_min, exact=False)
            bounces = bounces + 1
            # depth exhaustion ends the path with black (render.hpp:91)
            alive = st.alive & ~(st.alive & (bounces >= max_depth))
            finished = was_alive & ~alive
            acc = acc + vwhere(finished, st.radiance, Vec3(z, z, z))
            # regenerate: the pixel's next sample, if any is left
            s_next = s + slots
            regen = finished & (s_next < spp)
            s = torch.where(finished, s_next, s)
            path = start_paths(pix, s, regen, st._replace(alive=alive))
            bounces = torch.where(regen, 0, bounces)
            iters += 1
        part = torch.stack([c.reshape(slots, tile_pix).sum(0) for c in acc])
        p0 = tile_idx * tile_pix
        fb[:, p0:p0 + tile_pix] = fb[:, p0:p0 + tile_pix] + part
    img = fdiv(fb[:, :n_pix], float(spp)).T.reshape(height, width, 3)
    if return_stats:
        return img, {"segments": int(segments), "iters": iters,
                     "lanes": n_lanes, "tiles": n_tiles}
    if return_segments:
        return img, int(segments)
    return img
