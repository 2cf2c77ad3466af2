"""Probe states for holding one `wave_bounce` call against another.

`probe_state` makes a final-scene lane state a few bounces in, from a
numpy seed, with every case the kernel's policy branches on: live and
dead lanes, lanes that regenerate within their chunk, pending ALBEDO and
EMIT image-texture fixups, and lanes whose pending fixup the texel service
does not cover (they stall).  `tie_scene` is a scene made for equal
sphere keys across media segments, `media_scene` one with more media
than the kernel has templated instantiations for (past 23, more than its
shared-memory variants take), and `sphere_scene` one whose fold table is
too large to stage in shared memory.  `padding_rays` aims a state's rays
at the sphere table's padding; `texel_edge` makes the texel service's
edge states.  `agreement` compares two bounce
outputs plane by plane.  The tests use them against the reference
package on the CPU; `chip_smoke.py` and the card tests use them for the
kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.camera import Camera
from ..core.device import resolve_device
from ..core.rng import MASK32, seed_perf
from ..engine.integrator import camera_rays
from ..scene.builder import SceneBuilder
from ..scene.types import Scene
from . import wave_bounce as WB

INT_PLANES = ("rng", "win", "alive", "s", "bnc", "wrk", "fix_kind")
FLOAT_PLANES = ("ox", "oy", "oz", "dx", "dy", "dz", "tm", "tpx", "tpy", "tpz",
                "radx", "rady", "radz", "accx", "accy", "accz", "t_hit")
FIX_PLANES = ("fix_idx", "fwx", "fwy", "fwz")


def probe_state(tables: WB.SceneTables, cam: Camera, width: int,
                height: int, atlas_flat: torch.Tensor, *, rows: int,
                bounces: int = 3, max_depth: int = 50, seed: int = 0,
                t_min: float = 1e-3, tile_rows: int = 8
                ) -> Tuple[WB.WaveState, WB.FixState, torch.Tensor,
                           torch.Tensor]:
    """(state, fix, texel, srv) for one bounce call on `rows` x 128 lanes
    of random pixels, after `bounces` calls of `wave_bounce` on the
    tables' device."""
    dev = tables.sph.device
    rs = np.random.RandomState(seed)
    n = rows * WB.LANE
    sh = (rows, WB.LANE)
    f32 = torch.float32
    t = lambda a, dt=f32: torch.as_tensor(a, dtype=dt).reshape(sh).to(dev)
    n_atlas = atlas_flat.shape[0]

    pix = rs.randint(0, width * height, n)
    send = rs.randint(1, 4, n)               # 1..3 samples in the chunk
    rng0 = seed_perf(torch.as_tensor(pix), torch.zeros(n, dtype=torch.long),
                     torch.as_tensor(tables.seed).cpu())   # made on the host
    rng1, o, d, tm = camera_rays(cam, width, height, torch.as_tensor(pix),
                                 rng0)
    one, zero = t(np.ones(n)), t(np.zeros(n))
    st = WB.WaveState(
        ox=t(o.x), oy=t(o.y), oz=t(o.z), dx=t(d.x), dy=t(d.y), dz=t(d.z),
        tm=t(tm), rng=t(rng1, torch.int64), tpx=one, tpy=one, tpz=one,
        radx=zero, rady=zero, radz=zero, accx=zero, accy=zero, accz=zero,
        alive=one, s=zero, bnc=zero, wrk=zero, pix=t(pix), send=t(send),
        strd=one)
    fix = WB.zero_fix(rows, dev)

    def service(fx):
        texel = atlas_flat[torch.clamp(fx.idx.long(), 0, n_atlas - 1)]
        return texel, t(rs.rand(n) < 0.6)       # ~40% of fixups stall

    for _ in range(bounces):
        texel, srv = service(fix)
        out = WB.wave_bounce(tables, st, fix, texel, srv, t_min=t_min,
                             max_depth=max_depth, attenuate=False,
                             tile_rows=tile_rows)
        st, fix = out.state, out.fix

    # inject what the final scene rarely or never makes on its own: pending
    # EMIT fixups (an emitter with an image texture) on dead lanes, pending
    # ALBEDO fixups on live ones, and dead lanes with no sample left
    lanes = rs.permutation(n)
    k = max(n // 32, 1)
    emit, alb, dead = (torch.as_tensor(np.isin(np.arange(n), lanes[i * k:
                                                          (i + 1) * k]))
                       .reshape(sh).to(dev) for i in range(3))
    w = torch.where
    atlas_idx = t(rs.randint(0, n_atlas, n))
    fix = WB.FixState(
        kind=w(emit, WB.FIX_EMIT, w(alb, WB.FIX_ALBEDO, fix.kind)),
        idx=w(emit | alb, atlas_idx, fix.idx),
        fwx=w(emit, t(rs.rand(n)), fix.fwx), fwy=w(emit, t(rs.rand(n)),
                                                     fix.fwy),
        fwz=w(emit, t(rs.rand(n)), fix.fwz))
    st = st._replace(alive=w(emit | dead, 0.0, w(alb, 1.0, st.alive)),
                     send=w(dead, st.s, st.send))
    texel, srv = service(fix)
    return st, fix, texel, srv


def tie_scene(aspect: float, device="cuda") -> Tuple[Scene, Camera]:
    """A scene where the sphere fold meets many equal keys.  Each sphere
    of a small cluster is added several times with the same geometry and
    another material, so the lowest table index must win a tie, and the
    output shows which one did.  Two smoke media split the spheres into
    three media segments: segment 0 has static and moving copies,
    segment 1 moving copies only, segment 2 static copies (and the
    padding).  Equal copies thus sit on both sides of each medium."""
    sb = SceneBuilder()
    sb.add_sphere((0.0, -1000.0, 0.0), 1000.0, sb.lambertian((0.5, 0.5, 0.5)))
    mats = [sb.lambertian((0.8, 0.3, 0.3)), sb.metal((0.7, 0.7, 0.9), 0.1),
            sb.lambertian((0.3, 0.8, 0.3)), sb.dielectric(1.5, (1, 1, 1)),
            sb.lambertian((0.3, 0.3, 0.8))]
    cluster = [((x, 0.5, z), 0.5) for x in (-1.2, 0.0, 1.2)
               for z in (-1.2, 0.0, 1.2)]
    movers = [((x, 0.4, z), (x, 0.8, z), 0.4) for x, z in ((-0.6, 0.6),
                                                           (0.6, -0.6))]
    for c, r in cluster:
        sb.add_sphere(c, r, mats[0])
        sb.add_sphere(c, r, mats[1])
    for _ in range(2):
        for c0, c1, r in movers:
            sb.add_moving_sphere(c0, c1, 0.0, 1.0, r, mats[2])
    sb.add_constant_medium(("sphere", (0.0, 1.0, 0.0), 2.5), 0.05,
                           (0.9, 0.9, 0.9))
    for c0, c1, r in movers:
        sb.add_moving_sphere(c0, c1, 0.0, 1.0, r, mats[3])
    sb.add_constant_medium(("box", (-2.0, 0.0, -2.0), (2.0, 1.5, 2.0)), 0.02,
                           (0.8, 0.8, 0.6))
    for c, r in cluster:
        sb.add_sphere(c, r, mats[4])
    cam = Camera.create((0.0, 3.0, 6.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0),
                        35.0, aspect, 0.0, 6.5, 0.0, 1.0)
    return sb.build(device=resolve_device(device)), cam


# smoke volumes media_scene adds, in turn: (boundary, density, albedo)
_SMOKE = [(("sphere", (2.0, 0.6, 1.2), 0.6), 0.3, (0.9, 0.8, 0.7)),
          (("box", (5.5, 0.0, -1.0), (6.5, 1.2, 0.0)), 0.5, (0.6, 0.7, 0.9)),
          (("sphere", (-2.0, 0.8, 2.0), 0.8), 0.2, (0.9, 0.9, 0.9)),
          (("box", (7.5, 0.0, 1.5), (8.5, 0.8, 2.5)), 0.8, (0.8, 0.9, 0.6)),
          (("sphere", (1.0, 0.5, -3.0), 0.5), 1.0, (0.7, 0.7, 0.7))]


def _small_smoke(j: int):
    """The j-th small smoke volume after _SMOKE's: 0.3-sized spheres and
    boxes in turn on a grid over the ground in view."""
    x, z = -3.0 + 1.2 * (j % 8), -2.5 + 1.6 * (j // 8)
    if j % 2 == 0:
        boundary = ("sphere", (x, 0.35, z), 0.3)
    else:
        boundary = ("box", (x - 0.3, 0.0, z - 0.3), (x + 0.3, 0.6, z + 0.3))
    return boundary, 0.4 + 0.1 * (j % 5), (0.7, 0.8, 0.9)


def media_scene(aspect: float, n_media: int = 6, device="cuda"
                ) -> Tuple[Scene, Camera]:
    """The final scene (whose smoke ball comes last) with n_media - 1 more
    smoke volumes, sphere and box boundaries in turn, all in view: the
    five of `_SMOKE`, then small ones (`_small_smoke`).  A static and a
    moving sphere follow each medium, so that every media segment of the
    sphere fold after the final scene's own holds spheres of both kinds:
    past the 4 media counts the kernel is templated for, and past 23 the
    shared-memory variants' cap."""
    from ..scene.presets import final_scene_builder
    sb, cam = final_scene_builder(aspect)
    for i in range(n_media):
        x, z = 3.0 - 1.5 * i, 3.5 - 0.5 * i
        sb.add_sphere((x, 0.3, z), 0.3, sb.metal((0.8, 0.8, 0.8), 0.1 * i))
        sb.add_moving_sphere((x + 0.7, 0.25, z), (x + 0.7, 0.55, z), 0.0,
                             1.0, 0.25, sb.lambertian((0.2, 0.3 + 0.1 * i,
                                                       0.5)))
        if i < n_media - 1:
            n = len(_SMOKE)
            boundary, density, albedo = (_SMOKE[i] if i < n
                                         else _small_smoke(i - n))
            sb.add_constant_medium(boundary, density, albedo)
    return sb.build(device=resolve_device(device)), cam


def sphere_scene(aspect: float, n_static: int = 13000, seed: int = 0,
                 device="cuda") -> Tuple[Scene, Camera]:
    """The final scene with small static spheres (radius 0.04, on the
    ground in view, placed from a numpy seed) added until it holds
    `n_static` static spheres: at 16 bytes a static record (48 a moving
    one), its fold table passes the shared-memory variants' 192 KB."""
    from ..scene.presets import final_scene_builder
    sb, cam = final_scene_builder(aspect)
    rs = np.random.RandomState(seed)
    have = sum(1 for sp in sb._spheres if sp[3] == sp[4])
    mats = [sb.lambertian((0.8, 0.3, 0.3)), sb.metal((0.8, 0.8, 0.7), 0.2),
            sb.lambertian((0.3, 0.6, 0.8)), sb.dielectric(1.5, (1, 1, 1))]
    for k in range(max(n_static - have, 0)):
        x, z = rs.uniform(-11.0, 11.0), rs.uniform(-11.0, 11.0)
        sb.add_sphere((float(x), 0.04, float(z)), 0.04, mats[k % len(mats)])
    return sb.build(device=resolve_device(device)), cam


# a ray the final scene's padding once caught: at (1e9, 0, 0) with r^2 = 0,
# the float32 disc cancelled to a positive value, a "hit" at t 6.96e8
PADDING_RAY = ((4.7179, 1.0935, 1.5601), (1.4360, 0.0003, -0.0003))


def padding_rays(n: int, seed: int = 0) -> Tuple[torch.Tensor, ...]:
    """(ox, oy, oz, dx, dy, dz) of `n` rays on the CPU, from origins in
    [-10, 10]^3 toward (1e9, 0, 0), where `WB.pack_scene` puts the sphere
    table's padding: unit directions, every second one scaled by 0.5-3,
    and ray 0 `PADDING_RAY`."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-10.0, 10.0, (n, 3))
    d = np.array([1.0e9, 0.0, 0.0]) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[1::2] *= rs.uniform(0.5, 3.0, (len(d[1::2]), 1))
    o[0], d[0] = PADDING_RAY
    return tuple(torch.from_numpy(np.ascontiguousarray(v[:, i], np.float32))
                 for v in (o, d) for i in range(3))


TEXEL_ATLAS = 4096        # texels in the atlas the edge states index
TEXEL_EDGES = ("one_row", "heavy_over_cap", "full_row", "rbo_last_row",
               "none_pending", "odd_idx", "frame_width")


def _texel_state(rows, dens, rs):
    """kind (1 or 2 with probability dens[r] in row r) and idx planes."""
    kind = np.where(rs.rand(rows, WB.LANE) < np.asarray(dens)[:, None],
                    rs.randint(1, 3, (rows, WB.LANE)), 0).astype(np.float32)
    idx = np.floor(rs.uniform(0.0, float(TEXEL_ATLAS), (rows, WB.LANE)))
    return kind, idx.astype(np.float32)


def _k_with_rbo(rows, rbo):
    return next(k for k in range(10 ** 5) if (k * 997) % rows == rbo)


def texel_edge(case: str):
    """(kind, idx, ks) numpy planes of one of `TEXEL_EDGES`, the fix
    states at the edges of the texel service's rule, and the bounces k
    to serve them at."""
    rs = np.random.RandomState(sorted(TEXEL_EDGES).index(case))
    if case == "one_row":            # cap 1: the one heavy row is served
        kind, idx = _texel_state(1, [0.3], rs)
        return kind, idx, [0, 1, 7]
    if case == "heavy_over_cap":     # 32 rows, cap 4, ~12 heavy
        kind, idx = _texel_state(32, np.where(rs.rand(32) < 0.4, 0.2, 0.02),
                                 rs)
        return kind, idx, [0, 3, 11]
    if case == "full_row":           # a row with all 128 lanes pending
        kind, idx = _texel_state(
            8, [0.0, 0.01, 1.0, 0.05, 0.0, 0.5, 0.01, 0.0], rs)
        kind[2] = 1.0
        return kind, idx, [0, 5]
    if case == "rbo_last_row":       # the heavy-row rotation starts at rows-1
        kind, idx = _texel_state(24, np.linspace(0.0, 0.2, 24), rs)
        return kind, idx, [_k_with_rbo(24, 23), _k_with_rbo(24, 22)]
    if case == "none_pending":
        kind, idx = _texel_state(16, np.zeros(16), rs)
        return kind, idx, [0, 4]
    if case == "odd_idx":            # negative, non-integral, past the atlas
        kind, idx = _texel_state(16, np.full(16, 0.3), rs)
        idx = rs.uniform(-70.0, TEXEL_ATLAS + 70.0, kind.shape)
        return kind, idx.astype(np.float32), [0, 2]
    if case != "frame_width":
        raise ValueError(f"texel_edge: no case {case!r}")
    # a frame's width: 3,008 rows of 128 lanes, ~13% of lanes pending
    kind, idx = _texel_state(3008, np.clip(rs.exponential(0.13, 3008), 0, 1),
                             rs)
    return kind, idx, [0, 13, 31]


def planes(out: WB.WaveOut) -> Dict[str, torch.Tensor]:
    p = dict(out.state._asdict())
    p.update(fix_kind=out.fix.kind, fix_idx=out.fix.idx, fwx=out.fix.fwx,
             fwy=out.fix.fwy, fwz=out.fix.fwz, win=out.win, t_hit=out.t_hit)
    return {k: v.detach().cpu() for k, v in p.items()}


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in float32 steps (across zero too); NaN vs NaN is 0."""
    def key(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = (key(a) - key(b)).abs()
    return torch.where(torch.isnan(a) & torch.isnan(b), 0, d)


def agreement(a: WB.WaveOut, b: WB.WaveOut) -> Dict[str, float]:
    """Per-plane agreement of two bounce outputs: for each integer plane
    the fraction of lanes equal; for each float plane the fraction of the
    lanes whose win agrees that are within 4 ulp, and the largest ulp
    distance there (`*_max_ulp`).  Fixup planes are compared where a fixup
    is pending in both (elsewhere they are never read)."""
    pa, pb = planes(a), planes(b)
    res = {}
    for k in INT_PLANES:
        x, y = pa[k], pb[k]
        if k == "rng":
            x, y = x & MASK32, y & MASK32
        res[k] = float((x == y).double().mean())
    same_win = pa["win"] == pb["win"]
    fix_live = same_win & (pa["fix_kind"] != 0) & (pb["fix_kind"] != 0)
    for k in FLOAT_PLANES + FIX_PLANES:
        m = fix_live if k in FIX_PLANES else same_win
        u = _ulps(pa[k], pb[k])[m]
        res[k] = float((u <= 4).double().mean()) if u.numel() else 1.0
        res[k + "_max_ulp"] = float(u.max()) if u.numel() else 0.0
    res["win_lanes"] = float(same_win.double().mean())
    return res
