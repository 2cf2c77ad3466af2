"""Windowed work-queue renderer: the port's production forward path.

Mirrors the reference package's `engine/wq.py`: the windowed driver
(`wq_window_fb`, `render_wq`, `render_wq_range`) and, for
`render_wq(window=1)`, the one-bounce driver (`render_wq_one_bounce`).
Lanes that finish are refilled from a global chunk queue, so no lane idles
behind a long path:

1. refill: dead lanes are granted the next chunk (`chunk` consecutive
   samples of one pixel, pixel-major), seeded with `core.rng.seed_perf`,
   and given their camera ray by `integrator.camera_rays`; the finished
   chunk's radiance is banked in one of two per-lane slots.  On the card
   the CUDA kernel `ops.refill.refill` does it in two launches, bit-equal
   to `refill_plain`; the CPU runs `refill_plain`;
2. texel service: pending image-texture fixups get their atlas texel,
   S=4 per 128-lane row plus full service for a rotating set of heavy
   rows; uncovered lanes stall in the kernel.  On the card the CUDA
   kernel `ops.texel.texel` does it in two launches, bit-equal to
   `texel_service`; the CPU runs `texel_service`;
3. bounce: `ops.wave_bounce.wave_bounce`, the CUDA kernel, advances every
   lane one segment and regenerates within the chunk;
4. once per window of `window` bounces the banks are deposited into the
   framebuffer.

The reference's `while_loop` is a host loop here: one device-to-host read
per window for its condition (chunks left, or more live lanes than the
first drain stage holds).  Once the queue is empty the live lanes are
compacted into 4x narrower grids (the drain stages) as they die out.

A window is one function, `window_body`.  The CPU runs it eagerly.  On
the card each kind of window (its rows, whether it refills, whether it
deposits) runs eagerly the first time a call shape meets it, is captured
as a CUDA graph the second time, and is replayed from then on, in this
call and in later calls of the same shape (`WindowPlan`): a few hundred
small ATen launches a bounce become one graph launch a window, and a
call whose shape is seen once costs what the eager driver costs.  A
graph reads the call's values from device memory (the packed tables and
camera, the seed, the queue's length, the pixel and sample bases), so
only what a window takes as a Python value (sizes, the depth) keys a
capture: a moving camera or a new seed replays the same graphs.

The work queue's steps are written once, here, for every driver:
`k1_inputs` packs K1's inputs, and a refill is `grant`, `bank` and
`start_paths`, the caller supplying only its chunk map (which pixel and
samples an id names): `refill_plain`, `render_wq_one_bounce` and the
gradient route's recorder `diff.queued_vjp.record_forward_q`.

Deposits add in a fixed order: every contribution to one framebuffer
entry is added sequentially in the order the reference's scatter-adds
take them (bank slot 0's lanes, then slot 1's, each in lane order), via a
stable sort and gathers, with no atomics.  The result is the same on
every run and device and does not depend on thread timing.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..core.camera import Camera
from ..core.device import resolve_device
from ..core.rng import f32, seed_perf
from ..core.vec import fdiv, live_divisors
from ..scene import types as T
from ..ops import refill as RF
from ..ops import texel as TX
from ..ops import wave_bounce as WB
from .integrator import camera_rays

LANE = WB.LANE
DEF_TILE_ROWS = WB.DEF_TILE_ROWS   # lane-count quantum and drain granularity
CPU_TILE_ROWS = 8                  # the tests' quantum on the CPU
DEF_WINDOW = 32                    # bounces per deposit window on the card
CPU_WINDOW = 3
MAX_CHUNK = 10                     # samples per grant; chunk | spp
S_SLOTS = 4                        # texel-service slots per 128-lane row
INV255 = f32(1.0 / 255.0)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pick_chunk(spp: int, cap: int = MAX_CHUNK) -> int:
    """Largest divisor of spp <= cap: consecutive samples of one pixel
    granted per refill (the kernel regenerates within the chunk)."""
    for c in range(min(cap, spp), 0, -1):
        if spp % c == 0:
            return c
    return 1


def _pack_atlas_flat(atlas: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Atlas texels packed R | G<<8 | B<<16 into one flat int32 vector."""
    a = atlas.to(torch.int32)
    flat = a[:, 0] | (a[:, 1] << 8) | (a[:, 2] << 16)
    return flat, flat.shape[0]


def k1_inputs(scene: T.Scene, cam: Camera, width: int, height: int,
              seed: int, device: torch.device
              ) -> Tuple[WB.SceneTables, torch.Tensor, int]:
    """K1's inputs for one render on `device`: the scene's tables with the
    camera, the frame size and the seed word in place, then the atlas
    packed flat and its texel count: (tables, atlas_flat, n_atlas)."""
    tables = WB.pack_scene(scene, device)._replace(
        cam=WB.pack_camera(cam, width, height, device),
        seed=WB.seed_word(seed, device))
    return (tables, *_pack_atlas_flat(scene.textures.atlas.to(device)))


def texel_service(fx: WB.FixState, k: int, atlas_flat: torch.Tensor,
                  n_atlas: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Atlas texels for pending image-texture fixups under a bounded
    per-bounce budget; returns (texel (rows,128) int32, srv 0/1 f32).
    The kernel applies covered fixups and stalls the rest, so any
    coverage is correct.  This one serves the first S_SLOTS pending
    lanes of every row (in a lane order rotated by bounce `k`, so none
    starves) and gives rows with more pending lanes full service, up to
    rows//8 rows per bounce (rotated)."""
    rws = fx.kind.shape[0]
    dev = fx.kind.device
    idx = torch.clamp(fx.idx.long(), 0, n_atlas - 1)
    need = fx.kind != 0.0
    need_i = need.long()
    bo = (k * 37) % LANE
    need_r = torch.roll(need_i, -bo, dims=1)
    lrank = torch.roll(torch.cumsum(need_r, 1) - need_r, bo, dims=1)
    # primary slots: one small (rows, S) gather
    sidx = torch.stack([torch.where(need & (lrank == j), idx, 0).sum(1)
                        for j in range(S_SLOTS)], dim=1)
    stex = atlas_flat[sidx]
    texel = torch.zeros((rws, LANE), dtype=torch.int32, device=dev)
    for j in range(S_SLOTS):
        texel = torch.where(need & (lrank == j), stex[:, j:j + 1], texel)
    srv = need & (lrank < S_SLOTS)
    # spill: full-row service for rows with more than S pending lanes
    cap = max(rws // 8, 1)
    heavy_i = (need_i.sum(1) > S_SLOTS).long()
    rbo = (k * 997) % rws
    heavy_r = torch.roll(heavy_i, -rbo)
    hrank = torch.roll(torch.cumsum(heavy_r, 0) - heavy_r, rbo)
    served_row = (heavy_i > 0) & (hrank < cap)
    slot = torch.where(served_row, hrank, cap)
    row_ids = torch.full((cap + 1,), rws, dtype=torch.long, device=dev)
    row_ids = row_ids.scatter(0, slot, torch.arange(rws, device=dev))[:cap]
    ctex = atlas_flat[idx[torch.clamp(row_ids, 0, rws - 1)]]   # (cap, 128)
    srow = served_row[:, None] & need
    texel = torch.where(srow, ctex[torch.clamp(hrank, 0, cap - 1)], texel)
    return texel, (srv | srow).to(torch.float32)


def texel_plain(fx: WB.FixState, k: int, atlas_flat: torch.Tensor,
                n_atlas: int, counts: Optional[torch.Tensor] = None):
    """`texel_lanes` on any device by the plain service: `texel_service`,
    and `counts` plus `count_nonzero`'s (pending, served).  The CPU's
    path, and what a card render is held against with it in
    `texel_lanes`'s place."""
    texel, srv = texel_service(fx, k, atlas_flat, n_atlas)
    if counts is not None:
        counts = counts + torch.count_nonzero(torch.stack([fx.kind, srv]),
                                              dim=(1, 2))
    return texel, srv, counts


def texel_lanes(fx: WB.FixState, k: int, atlas_flat: torch.Tensor,
                n_atlas: int, counts: Optional[torch.Tensor] = None):
    """The texel service of bounce `k`, as `texel_service` returns it:
    on a CUDA carry the kernel (`ops.texel.texel`), on a CPU carry
    `texel_plain`; no fallback between them.  `counts`, where given, is
    the window's (pending, served) lane-bounces so far, a 2-word int64: the
    kernel adds this bounce's in the same launch, in place.  Returns
    (texel, srv, counts)."""
    dev = fx.kind.device
    if dev.type == "cuda":
        return (*TX.texel(fx, k, atlas_flat, n_atlas, counts), counts)
    if dev.type != "cpu":
        raise ValueError(f"texel service: unsupported device {dev}")
    return texel_plain(fx, k, atlas_flat, n_atlas, counts)


def resolve_fixups(st: WB.WaveState, fix: WB.FixState,
                   atlas_flat: torch.Tensor, n_atlas: int):
    """Resolve one bounce's image-texture fixups in the driver, as the
    reference's one-bounce driver and pixel-pinned recorder do after a K1
    call made with fix=None: gather every lane's atlas texel, multiply the
    throughput of FIX_ALBEDO lanes by it, and weight the emission of
    FIX_EMIT lanes by it (texture.hpp:144-150).  Returns (state with the
    throughput updated, (er, eg, eb) the emission, 0 on other lanes, and
    the int32 texels)."""
    idx = torch.clamp(fix.idx.long(), 0, n_atlas - 1)
    texel = atlas_flat[idx]
    tx = [((texel >> sh) & 0xFF).to(torch.float32) * INV255
          for sh in (0, 8, 16)]
    is_alb = fix.kind == WB.FIX_ALBEDO
    is_emit = fix.kind == WB.FIX_EMIT
    w = torch.where
    st = st._replace(tpx=w(is_alb, st.tpx * tx[0], st.tpx),
                     tpy=w(is_alb, st.tpy * tx[1], st.tpy),
                     tpz=w(is_alb, st.tpz * tx[2], st.tpz))
    emit = tuple(w(is_emit, fw * t, 0.0)
                 for fw, t in zip((fix.fwx, fix.fwy, fix.fwz), tx))
    return st, emit, texel


class WqwExtra(NamedTuple):
    """Driver-side deposit banks the kernel never sees, (rows, 128) f32:
    two (pixel, rgb) slots per lane, flushed once per window (pix < 0 =
    empty)."""
    bpix0: torch.Tensor
    br0: torch.Tensor
    bg0: torch.Tensor
    bb0: torch.Tensor
    bpix1: torch.Tensor
    br1: torch.Tensor
    bg1: torch.Tensor
    bb1: torch.Tensor


def _zeros_extra(rows: int, device) -> WqwExtra:
    z = torch.zeros((rows, LANE), dtype=torch.float32, device=device)
    neg = torch.full((rows, LANE), -1.0, dtype=torch.float32, device=device)
    return WqwExtra(neg, z, z, z, neg, z, z, z)


def _zeros_state(rows: int, device) -> WB.WaveState:
    sh = (rows, LANE)
    z = torch.zeros(sh, dtype=torch.float32, device=device)
    neg = torch.full(sh, -1.0, dtype=torch.float32, device=device)
    return WB.WaveState(
        ox=z, oy=z, oz=z, dx=z, dy=z, dz=z, tm=z,
        rng=torch.zeros(sh, dtype=torch.int64, device=device),
        tpx=z, tpy=z, tpz=z, radx=z, rady=z, radz=z, accx=z, accy=z, accz=z,
        alive=z, s=neg, bnc=z, wrk=z, pix=neg, send=z,
        strd=torch.ones(sh, dtype=torch.float32, device=device))


def _add_in_order(fb: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                  n_slots: int, max_per_slot: int) -> torch.Tensor:
    """fb[idx[k]] += vals[k] for every k with idx[k] < n_slots, each entry
    summed sequentially in k order (entries >= n_slots are dropped).
    `max_per_slot` bounds the contributions to one entry."""
    sidx, perm = torch.sort(idx, stable=True)
    sv = vals[perm]
    slots = torch.arange(n_slots, device=fb.device)
    lo = torch.searchsorted(sidx, slots)
    hi = torch.searchsorted(sidx, slots, right=True)
    last = sidx.numel() - 1
    head = fb[:n_slots]
    for r in range(max_per_slot):
        p = lo + r
        head = head + torch.where(p < hi, sv[torch.clamp(p, max=last)], 0.0)
    return torch.cat([head, fb[n_slots:]])


def _plane_idx(bpix: torch.Tensor, n_pix: int, pix_base: float):
    """Flat framebuffer entries [r-plane, g-plane, b-plane] of each lane's
    pixel, pix_base subtracted; lanes without one (pix < 0) go to the drop
    slot 3*n_pix."""
    valid = bpix >= 0.0
    base = (bpix - pix_base).long()
    return [torch.where(valid, base + c * n_pix, 3 * n_pix).reshape(-1)
            for c in range(3)]


def deposit(ex: WqwExtra, fb: torch.Tensor, n_pix: int, max_per: int,
            pix_base: float = 0.0) -> Tuple[WqwExtra, torch.Tensor]:
    """Flush both bank slots into the flat framebuffer (n_pix per plane
    plus the drop slot) in the reference's update order; returns the
    emptied banks and fb.  An entry takes at most `max_per`
    contributions (one a banked chunk)."""
    idx = torch.cat(_plane_idx(ex.bpix0, n_pix, pix_base)
                    + _plane_idx(ex.bpix1, n_pix, pix_base))
    vals = torch.cat([v.reshape(-1) for v in (ex.br0, ex.bg0, ex.bb0,
                                              ex.br1, ex.bg1, ex.bb1)])
    fb = _add_in_order(fb, idx, vals, 3 * n_pix, max_per)
    return _zeros_extra(ex.bpix0.shape[0], fb.device), fb


def flush_acc(st: WB.WaveState, fb: torch.Tensor, n_pix: int, max_per: int,
              pix_base: float = 0.0) -> torch.Tensor:
    """Every lane's chunk accumulator into the framebuffer (stage
    boundaries and the final residual flush)."""
    vals = torch.cat([st.accx.reshape(-1), st.accy.reshape(-1),
                      st.accz.reshape(-1)])
    return _add_in_order(fb, torch.cat(_plane_idx(st.pix, n_pix, pix_base)),
                         vals, 3 * n_pix, max_per)


def compact(st: WB.WaveState, fx: WB.FixState, new_rows: int):
    """Pack the live lanes (and their pending fixups) into a (new_rows, 128)
    state.  Dead lanes with a pending EMIT fixup count as live.  acc must
    be flushed and wrk summed first (both are zeroed); pad lanes get
    alive=0 and pix=s=send=-1 so the kernel neither traces nor
    regenerates them.  Returns (state, fix, perm, valid, nlive): perm is
    the old flat lane of each new lane, valid masks the real ones, and
    nlive (a 0-d tensor) may exceed the new width, in which case the
    lanes past it are dropped."""
    dev = st.ox.device
    old = st.ox.numel()
    w = new_rows * LANE
    live = ((st.alive > 0.0) | (fx.kind != 0.0)).reshape(-1)
    live_i = live.long()
    rank = torch.cumsum(live_i, 0) - live_i
    tgt = torch.where(live & (rank < w), rank, w)        # w = dropped
    perm = torch.zeros(w + 1, dtype=torch.long, device=dev).scatter(
        0, tgt, torch.arange(old, device=dev))[:w]
    nlive = live_i.sum()
    valid = (torch.arange(w, device=dev) < nlive).reshape(new_rows, LANE)
    p2 = perm.reshape(new_rows, LANE)
    g = lambda a: a.reshape(-1)[p2]
    wh = torch.where
    z = torch.zeros((new_rows, LANE), dtype=torch.float32, device=dev)
    fx2 = WB.FixState(kind=wh(valid, g(fx.kind), 0.0), idx=g(fx.idx),
                      fwx=g(fx.fwx), fwy=g(fx.fwy), fwz=g(fx.fwz))
    st2 = WB.WaveState(
        ox=g(st.ox), oy=g(st.oy), oz=g(st.oz), dx=g(st.dx), dy=g(st.dy),
        dz=g(st.dz), tm=g(st.tm), rng=g(st.rng), tpx=g(st.tpx),
        tpy=g(st.tpy), tpz=g(st.tpz), radx=g(st.radx), rady=g(st.rady),
        radz=g(st.radz), accx=z, accy=z, accz=z,
        alive=wh(valid, g(st.alive), 0.0), s=wh(valid, g(st.s), -1.0),
        bnc=g(st.bnc), wrk=z, pix=wh(valid, g(st.pix), -1.0),
        send=wh(valid, g(st.send), -1.0),
        strd=wh(valid, g(st.strd), 1.0))
    return st2, fx2, perm, valid, nlive


class WindowCall(NamedTuple):
    """What every window of one `wq_window_fb` call reads besides its
    carry.  The values that change from call to call without changing a
    window's shape (the packed tables, among them the camera and the
    seed, the atlas, the queue's length, the chunks a pixel, the pixel
    and sample bases) are tensors on the device, so a captured window
    reads them from memory; the rest are Python values, and key the
    capture."""
    tables: WB.SceneTables      # the refill's camera is WB.table_camera's
    atlas_flat: torch.Tensor
    n_chunks: torch.Tensor      # 0-d int64: chunks the queue grants
    vcpp: torch.Tensor          # 0-d int64: chunks a pixel, >= 1
    pix_base: torch.Tensor      # 0-d f32
    samp_base: torch.Tensor     # 0-d f32
    n_atlas: int
    width: int
    height: int
    chunk: int
    cpp: int                    # contributions an entry takes at most
    n_pix_loc: int
    window: int
    max_depth: int
    attenuate: bool
    t_min: float
    tile_rows: int


CALL_INPUTS = WindowCall._fields[:6]   # the tensors a call copies in


class Carry(NamedTuple):
    """A window's state, in and out.  A drain window (no refill, no
    deposit) carries no banks and no framebuffer: ex and fb are None."""
    st: WB.WaveState
    ex: Optional[WqwExtra]
    fx: WB.FixState
    fb: Optional[torch.Tensor]
    counter: torch.Tensor       # 0-d int64: chunks granted


def zero_carry(rows: int, n_pix: int, device) -> Carry:
    """A first window's carry: no lane holds a chunk, the banks are empty,
    the framebuffer (n_pix per plane plus the drop slot) is zero."""
    return Carry(st=_zeros_state(rows, device), ex=_zeros_extra(rows, device),
                 fx=WB.zero_fix(rows, device),
                 fb=torch.zeros(3 * n_pix + 1, dtype=torch.float32,
                                device=device),
                 counter=torch.zeros((), dtype=torch.long, device=device))


def _leaves(tree) -> list:
    """The tensors of nested tuples, in order; None is skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _leaves(x)]
    return []


def _clone(tree):
    """Nested NamedTuples with every tensor cloned, so that no two share
    memory even where the original's did; None stays None."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, tuple):
        return type(tree)(*[_clone(x) for x in tree])
    return tree


def _copy_into(dst, src) -> None:
    for d, s in zip(_leaves(dst), _leaves(src), strict=True):
        d.copy_(s)


def eligible(st: WB.WaveState, ex: WqwExtra, fx: WB.FixState
             ) -> torch.Tensor:
    """The lanes a chunk refill may grant: dead, with no pending EMIT
    fixup (the texel service adds its emission to acc first), and with a
    free bank slot for the chunk they hold, if they hold one."""
    dead = (st.alive <= 0.0) & (fx.kind != WB.FIX_EMIT)
    return dead & ((ex.bpix0 < 0.0) | (ex.bpix1 < 0.0) | ~(st.pix >= 0.0))


def grant(elig: torch.Tensor, counter: torch.Tensor, n_total):
    """The queue's grant: the eligible lanes, in lane order, take the ids
    counter, counter + 1, ... while ids below `n_total` are left.
    Returns (granted lanes, each lane's id (granted or not), the new
    counter)."""
    elig_i = elig.reshape(-1).long()
    rank = torch.cumsum(elig_i, 0) - elig_i          # exclusive prefix
    navail = n_total - counter
    granted = (elig.reshape(-1) & (rank < navail)).reshape(elig.shape)
    return (granted, counter + rank.reshape(elig.shape),
            counter + torch.minimum(elig_i.sum(), navail))


def bank(st: WB.WaveState, ex: WqwExtra, granted: torch.Tensor) -> WqwExtra:
    """The chunk each granted lane finished, banked into its free slot
    (slot 0 first)."""
    do_bank = granted & (st.pix >= 0.0)
    slot0_free = ex.bpix0 < 0.0
    use0 = do_bank & slot0_free
    use1 = do_bank & ~slot0_free
    w = torch.where
    return WqwExtra(
        bpix0=w(use0, st.pix, ex.bpix0), br0=w(use0, st.accx, ex.br0),
        bg0=w(use0, st.accy, ex.bg0), bb0=w(use0, st.accz, ex.bb0),
        bpix1=w(use1, st.pix, ex.bpix1), br1=w(use1, st.accx, ex.br1),
        bg1=w(use1, st.accy, ex.bg1), bb1=w(use1, st.accz, ex.bb1))


def start_paths(st: WB.WaveState, granted: torch.Tensor, pix, s0, send,
                cam: Camera, width: int, height: int, seed) -> WB.WaveState:
    """Start the granted lanes' paths: a lane's (pix, s0) seeds its stream
    (`seed_perf`, `seed` an int or the seed word) and its camera ray, its
    path and accumulator are reset, and the kernel's in-chunk
    regeneration runs on to `send`.  pix, s0 and send hold exact ints
    (any dtype), one for every lane."""
    sh = st.pix.shape
    f32 = torch.float32
    pix_u = pix.reshape(-1).long()
    rng0 = seed_perf(pix_u, s0.reshape(-1).long(), seed)
    rng1, o, d, tmv = camera_rays(cam, width, height, pix_u, rng0)
    w = torch.where
    sel = lambda new, old: w(granted, new.reshape(sh), old)
    return st._replace(
        ox=sel(o.x, st.ox), oy=sel(o.y, st.oy), oz=sel(o.z, st.oz),
        dx=sel(d.x, st.dx), dy=sel(d.y, st.dy), dz=sel(d.z, st.dz),
        tm=sel(tmv, st.tm), rng=sel(rng1, st.rng),
        tpx=w(granted, 1.0, st.tpx), tpy=w(granted, 1.0, st.tpy),
        tpz=w(granted, 1.0, st.tpz), radx=w(granted, 0.0, st.radx),
        rady=w(granted, 0.0, st.rady), radz=w(granted, 0.0, st.radz),
        alive=w(granted, 1.0, st.alive), bnc=w(granted, 0.0, st.bnc),
        pix=sel(pix.to(f32), st.pix), s=sel(s0.to(f32), st.s),
        send=sel(send.to(f32), st.send),
        accx=w(granted, 0.0, st.accx), accy=w(granted, 0.0, st.accy),
        accz=w(granted, 0.0, st.accz))


def refill_plain(c: WindowCall, st: WB.WaveState, ex: WqwExtra,
                 counter: torch.Tensor, fx: WB.FixState,
                 noop: torch.Tensor):
    """Grant dead lanes the next chunk of the pixel-major queue, bank
    their finished chunk and launch the new chunk's first camera ray (the
    kernel's in-chunk regeneration continues the same streams), on any
    device: the CPU's refill, and the yardstick the card's kernel
    `ops.refill.refill` is held to.  Returns (st, ex, counter, noop),
    noop one more if the counter did not move."""
    f32 = torch.float32
    granted, cid, new = grant(eligible(st, ex, fx), counter, c.n_chunks)
    pix = c.pix_base + torch.div(cid, c.vcpp, rounding_mode="floor").to(f32)
    s0 = c.samp_base + ((cid % c.vcpp) * c.chunk).to(f32)
    ex = bank(st, ex, granted)
    st = start_paths(st, granted, pix, s0, s0 + float(c.chunk),
                     WB.table_camera(c.tables.cam), c.width, c.height,
                     c.tables.seed)
    return st, ex, new, noop + (new == counter)


def refill_lanes(c: WindowCall, st: WB.WaveState, ex: WqwExtra,
                 counter: torch.Tensor, fx: WB.FixState,
                 noop: torch.Tensor):
    """One refill, as `refill_plain` returns it: on a CUDA carry the
    kernel (`ops.refill.refill`, in place), on a CPU carry
    `refill_plain`; no fallback between them."""
    dev = st.pix.device
    if dev.type == "cuda":
        return RF.refill(c, st, ex, counter, fx, noop)
    if dev.type != "cpu":
        raise ValueError(f"refill: unsupported device {dev}")
    return refill_plain(c, st, ex, counter, fx, noop)


def _nlive(st: WB.WaveState, fx: WB.FixState) -> torch.Tensor:
    # lanes with a pending fixup still owe work or radiance
    return ((st.alive > 0.0) | (fx.kind != 0.0)).sum()


def _textured(c: WindowCall) -> bool:
    """Whether the scene has an image texture: the atlas holds more than
    the fallback texel."""
    return c.n_atlas > 1


def _spans(c: WindowCall) -> bool:
    """Whether K1 times its phases in the call's windows: on the card."""
    return c.tables.cam.device.type == "cuda"


def read_size(c: WindowCall, refill: bool) -> int:
    """The numbers of a window's host read (`window_body`)."""
    return (2 + int(refill) + 2 * int(_textured(c))
            + len(WB.PHASES) * int(_spans(c)))


def window_body(c: WindowCall, cy: Carry, refill: bool
                ) -> Tuple[Carry, torch.Tensor]:
    """One window: `c.window` bounces of [refill] + texel service + K1,
    then, where the carry has banks, their deposit.  The eager driver
    (the CPU) runs it, and the card captures it (`WindowGraph`).
    Returns the carry after it and the window's host read, an int64
    tensor [chunks granted, live lanes], then where it refills [refills
    that granted nothing], where the scene has an image texture
    [lane-bounces with a pending fixup, those the texel service
    covered], and on the card K1's cycles in each of its phases
    (`WB.PHASES`)."""
    st, ex, fx, fb, counter = cy
    i64, dev = torch.int64, counter.device
    noop = torch.zeros((), dtype=i64, device=dev) if refill else None
    texels = torch.zeros(2, dtype=i64, device=dev) if _textured(c) else None
    spans = torch.zeros(len(WB.PHASES), dtype=i64, device=dev) \
        if _spans(c) else None
    for k in range(c.window):
        if refill:
            st, ex, counter, noop = refill_lanes(c, st, ex, counter, fx, noop)
        texel, srv, texels = texel_lanes(fx, k, c.atlas_flat, c.n_atlas,
                                         texels)
        out = WB.wave_bounce(c.tables, st, fix=fx, texel=texel, srv=srv,
                             t_min=c.t_min, max_depth=c.max_depth,
                             attenuate=c.attenuate, tile_rows=c.tile_rows,
                             spans=spans)
        st, fx = out.state, out.fix
    if ex is not None:
        ex, fb = deposit(ex, fb, c.n_pix_loc, c.cpp, c.pix_base)
    read = [counter, _nlive(st, fx)]
    if refill:
        read.append(noop)
    if texels is not None:
        read += texels.unbind()
    if spans is not None:
        read += spans.unbind()
    return Carry(st, ex, fx, fb, counter), torch.stack(read)


GRAPH_PLANS = 4   # call shapes whose captured windows the card keeps
_plans: "OrderedDict[tuple, WindowPlan]" = OrderedDict()
_pools: dict = {}  # device -> the memory pool its captured windows share


class WindowGraph:
    """One kind of window captured as a CUDA graph over `window_body`,
    on the current device.  The graph reads the plan's call inputs and
    its own static carry, and its last nodes copy the window's final
    carry back into that static carry and the host read into `read`: a
    replay continues where the last one ended.  Capturing runs nothing:
    the kernels' launch counters give back what the capture added, and
    each replay adds it again (K1's with its events, `count_replay`)."""

    def __init__(self, c: WindowCall, static: Carry, refill: bool, pool):
        self.carry = static
        self.device = static.counter.device
        self.read = torch.zeros(read_size(c, refill), dtype=torch.int64,
                                device=self.device)
        self.graph = torch.cuda.CUDAGraph()
        kernels = (WB.wave_bounce, RF.refill, TX.texel)
        before = [f.launches for f in kernels]
        with torch.cuda.graph(self.graph, pool=pool):
            out, read = window_body(c, static, refill)
            _copy_into(static, out)
            self.read.copy_(read)
        k1, self.refills, self.texels = (f.launches - n for f, n in
                                         zip(kernels, before))
        for f, n in zip(kernels, before):
            f.launches = n
        self.lanes = [static.st.pix.numel()] * k1   # of each K1 launch
        self.divisors = live_divisors()   # the graph reads them in place

    def replay(self) -> None:
        WB.count_replay(self.lanes, self.graph.replay, self.device)
        RF.refill.launches += self.refills
        TX.texel.launches += self.texels


class WindowPlan:
    """A call shape's windows on the card: the static call inputs, which
    each call copies its own into (`load`), the kinds of window (rows,
    refill, deposit) run once, and one `WindowGraph` a kind run twice."""

    def __init__(self, c: WindowCall):
        self.call = c._replace(**{f: _clone(getattr(c, f))
                                  for f in CALL_INPUTS})
        self.seen: set = set()
        self.graphs: dict = {}

    @torch.no_grad()
    def load(self, c: WindowCall) -> None:
        for f in CALL_INPUTS:
            _copy_into(getattr(self.call, f), getattr(c, f))

    @torch.no_grad()
    def run(self, cy: Carry, refill: bool) -> Tuple[Carry, list]:
        """One window from carry `cy`, on its device: run eagerly the
        first time its kind comes, captured from a static copy of `cy`
        the second time, and replayed then and after."""
        kind = (cy.st.ox.shape[0], refill, cy.ex is not None)
        dev = cy.counter.device
        with torch.cuda.device(dev):
            g = self.graphs.get(kind)
            if g is None and kind not in self.seen:
                self.seen.add(kind)
                wq_window_fb.eager_windows += 1
                cy, read = window_body(self.call, cy, refill)
                return cy, read.tolist()
            if g is None:
                pool = _pools.setdefault(dev, torch.cuda.graph_pool_handle())
                g = self.graphs[kind] = WindowGraph(self.call, _clone(cy),
                                                    refill, pool)
                wq_window_fb.captures += 1
            elif cy is not g.carry:
                _copy_into(g.carry, cy)
            g.replay()
            wq_window_fb.replays += 1
            return g.carry, g.read.tolist()


def _plan_key(c: WindowCall) -> tuple:
    """Everything a captured window takes as a Python value."""
    return (c.tables.cam.device, c.width, c.height, c.tile_rows,
            c.window, c.chunk, c.cpp, c.n_pix_loc, c.n_atlas, c.max_depth,
            float(c.t_min), bool(c.attenuate),
            tuple(tuple(t.shape) for t in _leaves(c.tables)))


def window_plan(c: WindowCall) -> WindowPlan:
    """The card's plan for `c`'s shape, with `c`'s inputs loaded: kept
    across calls, the least recently used of GRAPH_PLANS dropped."""
    key = _plan_key(c)
    plan = _plans.pop(key, None)
    if plan is None:
        if len(_plans) >= GRAPH_PLANS:
            _plans.popitem(last=False)
        plan = WindowPlan(c)
    else:
        plan.load(c)
    _plans[key] = plan
    return plan


def _replays(dev: torch.device) -> bool:
    """Whether the windows of a call on `dev` go through CUDA graphs: on
    the card they do."""
    return dev.type == "cuda"


def window_call(scene: T.Scene, cam: Camera, width: int, height: int, *,
                n_pix_loc: int, chunk: int, cpp: int, n_chunks: int,
                vcpp: int, pix_base: int, samp_base: int, window: int,
                max_depth: int, attenuate: bool, t_min: float,
                tile_rows: int, seed: int, device: torch.device
                ) -> WindowCall:
    """The scene packed for K1 and one call's values, on `device`.  The
    0-d words are written by fill kernels: nothing waits on the card."""
    word = lambda v, dt: torch.full((), v, dtype=dt, device=device)
    tables, atlas_flat, n_atlas = k1_inputs(scene, cam, width, height, seed,
                                            device)
    return WindowCall(
        tables=tables, atlas_flat=atlas_flat,
        n_chunks=word(n_chunks, torch.int64),
        vcpp=word(max(vcpp, 1), torch.int64),
        pix_base=word(float(pix_base), torch.float32),
        samp_base=word(float(samp_base), torch.float32), n_atlas=n_atlas,
        width=width, height=height, chunk=chunk, cpp=cpp,
        n_pix_loc=n_pix_loc, window=window, max_depth=max_depth,
        attenuate=attenuate, t_min=t_min, tile_rows=tile_rows)


def wq_window_fb(scene: T.Scene, cam: Camera, width: int, height: int, *,
                 n_pix_loc: int, spp_loc: int, chunk: int, window: int,
                 max_depth: int, attenuate: bool, t_min: float,
                 tile_rows: int, seed: int, device: torch.device,
                 pix_base: int = 0, samp_base: int = 0,
                 valid_pix: Optional[int] = None,
                 valid_cpp: Optional[int] = None):
    """Windowed work-queue core over pixels [pix_base, pix_base+n_pix_loc)
    and samples [samp_base, samp_base+spp_loc) of each: the whole frame, or
    one shard of it (`parallel.mesh.render_sharded`).  A ragged shard
    grants only its first `valid_pix` pixels and `valid_cpp` chunks of
    each (default: all).  Returns (fb_sum (n_pix_loc, 3) unnormalised,
    row i for pixel pix_base+i, traced_segments, bounce_iters,
    lane_steps); occupancy = traced_segments / lane_steps.

    On the card each kind of window runs eagerly once, is captured as a
    CUDA graph the second time (`WindowPlan`) and is replayed, in this
    call and in later calls of the same shape; `wq_window_fb.captures`,
    `.replays` and `.eager_windows` count them (the card's windows only).
    Where the scene has an image texture, `wq_window_fb.texel_pending`
    counts the lane-bounces of every window with a pending fixup and
    `.texel_stalled` those the texel service left uncovered, which stall
    in the kernel; `wq_window_fb.refill_noop` counts the refills that
    granted no chunk; on the card `ops.wave_bounce.wave_bounce.
    phase_cycles` adds K1's cycles by phase.  All come in the window's one
    host read."""
    C = chunk
    cpp = spp_loc // C
    if cpp * C != spp_loc:
        raise ValueError(f"chunk {C} must divide spp_loc {spp_loc}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if n_pix_loc * spp_loc >= 2 ** 31:
        raise ValueError("sample ids must fit in int32")
    dev = device
    valid_pix = n_pix_loc if valid_pix is None else int(valid_pix)
    valid_cpp = cpp if valid_cpp is None else int(valid_cpp)
    n_chunks = valid_pix * valid_cpp
    quantum = tile_rows * LANE
    rows = _round_up(min(n_pix_loc, n_pix_loc * spp_loc), quantum) // LANE

    c = window_call(scene, cam, width, height, n_pix_loc=n_pix_loc,
                    chunk=C, cpp=cpp, n_chunks=n_chunks, vcpp=valid_cpp,
                    pix_base=pix_base, samp_base=samp_base, window=window,
                    max_depth=max_depth, attenuate=attenuate, t_min=t_min,
                    tile_rows=tile_rows, seed=seed, device=dev)
    if _replays(dev):
        run_window = window_plan(c).run
    else:
        def run_window(cy, refill):
            cy, read = window_body(c, cy, refill)
            return cy, read.tolist()

    def run(cy, refill):
        cy, read = run_window(cy, refill)
        rest = read[2 + refill:]
        if refill:
            wq_window_fb.refill_noop += read[2]
        if _textured(c):
            wq_window_fb.texel_pending += rest[0]
            wq_window_fb.texel_stalled += rest[0] - rest[1]
            rest = rest[2:]
        if rest:
            cycles = WB.wave_bounce.phase_cycles
            WB.wave_bounce.phase_cycles = [a + b for a, b in zip(cycles, rest)]
        return cy, read[:2]

    # drain stages: narrow the grid 4x per stage as the live set decays
    n_tiles = rows // tile_rows
    stage_tiles = []
    t = n_tiles
    while t > 1 and len(stage_tiles) < 3:
        t = max(1, t // 4)
        stage_tiles.append(t)
    caps = [t * quantum for t in stage_tiles]
    cap1 = caps[0] if caps else 0

    cy = zero_carry(rows, n_pix_loc, dev)
    granted, live, wins = 0, 0, 0
    while granted < n_chunks or live > cap1:   # one host read per window
        # once every chunk is granted every refill is a no-op
        cy, (granted, live) = run(cy, granted < n_chunks)
        wins += 1
    st, fx, fb = cy.st, cy.fx, cy.fb
    iters = wins * window
    lane_steps = float(iters * rows * LANE)

    wrk_tot = 0.0
    for i, stiles in enumerate(stage_tiles):
        wrk_tot += float(st.wrk.sum(dtype=torch.float64))
        fb = flush_acc(st, fb, n_pix_loc, cpp, pix_base)
        st, fx = compact(st, fx, stiles * tile_rows)[:2]
        next_cap = caps[i + 1] if i + 1 < len(caps) else 0
        w2 = 0
        live = int(_nlive(st, fx))
        while live > next_cap:
            cy, (_, live) = run(Carry(st, None, fx, None, cy.counter), False)
            st, fx = cy.st, cy.fx
            w2 += 1
        iters += w2 * window
        lane_steps += float(w2 * window * stiles * tile_rows * LANE)

    # residual flush: each lane's last chunk was never re-granted
    fb = flush_acc(st, fb, n_pix_loc, cpp, pix_base)
    segs = wrk_tot + float(st.wrk.sum(dtype=torch.float64))
    fb3 = fb[:3 * n_pix_loc].reshape(3, n_pix_loc).transpose(0, 1)
    return fb3, segs, iters, lane_steps


wq_window_fb.captures = 0       # windows captured as CUDA graphs
wq_window_fb.replays = 0        # windows run as a graph's replay
wq_window_fb.eager_windows = 0  # card windows run eagerly (a kind's first
#                                 in a call shape); hit share = replays /
#                                 (replays + eager_windows)
wq_window_fb.texel_pending = 0  # lane-bounces with a pending image-texture
#                                 fixup, every window, on any device
wq_window_fb.texel_stalled = 0  # of those, the ones the texel service did
#                                 not cover (lost lane-steps)
wq_window_fb.refill_noop = 0    # refills that granted no chunk, every
#                                 window, on any device


def render_wq_one_bounce(scene: T.Scene, cam: Camera, width: int,
                         height: int, spp: int, *, max_depth: int,
                         attenuate: bool, t_min: float, tile_rows: int,
                         seed: int, device: torch.device):
    """The one-bounce work-queue driver, the reference's `_render_wq_jit`:
    the reference's slow cross-check of the windowed driver, not a
    production path.  Lanes are pinned to one sample each; every bounce
    grants dead lanes the next sample ids (an exclusive prefix over the
    dead lanes), launches K1 once with no pending fixups, resolves that
    call's image-texture fixups here (`resolve_fixups`), and deposits the
    samples that finished into the framebuffer, every entry's
    contributions in lane order (`_add_in_order`).  Its loop condition
    (samples left to grant, or a lane alive) costs one host read a
    bounce.  Returns (img (H, W, 3), traced_segments, bounce_iters,
    lane_steps = bounce_iters * lanes)."""
    n_pix = width * height
    total = n_pix * spp
    if total >= 2 ** 31:
        raise ValueError("sample ids must fit in int32")
    dev = device
    lanes = _round_up(min(n_pix, total), tile_rows * LANE)
    rows = lanes // LANE
    sh = (rows, LANE)

    tables, atlas_flat, n_atlas = k1_inputs(scene, cam, width, height, seed,
                                            dev)

    def refill(st: WB.WaveState, counter: torch.Tensor):
        """Grant dead lanes the next sample ids and start their paths.
        send = s: the kernel's in-chunk regeneration never fires; the
        queue is the only sample source."""
        granted, sid, counter = grant(st.alive <= 0.0, counter, total)
        pix = torch.div(sid, spp, rounding_mode="floor")
        k = sid - pix * spp
        return start_paths(st, granted, pix, k, k, cam, width, height,
                           tables.seed), counter

    st = _zeros_state(rows, dev)
    fb = torch.zeros(3 * n_pix + 1, dtype=torch.float32, device=dev)
    counter = torch.zeros((), dtype=torch.long, device=dev)
    z = torch.zeros(sh, dtype=torch.float32, device=dev)
    iters, more = 0, True
    while more:
        st, counter = refill(st, counter)
        out = WB.wave_bounce(tables, st, t_min=t_min, max_depth=max_depth,
                             attenuate=attenuate, tile_rows=tile_rows)
        st, emit, _ = resolve_fixups(out.state, out.fix, atlas_flat, n_atlas)
        # acc was zero going in: it holds the radiance of the samples that
        # finished this bounce.  A lane holds one sample id at a time and
        # ids are granted once, so a pixel takes at most spp of them.
        vals = torch.cat([(a + e).reshape(-1) for a, e in zip(
            (st.accx, st.accy, st.accz), emit)])
        fb = _add_in_order(fb, torch.cat(_plane_idx(st.pix, n_pix, 0.0)),
                           vals, 3 * n_pix, spp)
        st = st._replace(accx=z, accy=z, accz=z)
        iters += 1
        granted, alive = torch.stack(                 # one host read
            [counter, (st.alive > 0.0).any().long()]).tolist()
        more = granted < total or bool(alive)
    img = fdiv(fb[:3 * n_pix].reshape(3, n_pix).transpose(0, 1),
               float(spp)).reshape(height, width, 3)
    segs = float(st.wrk.sum(dtype=torch.float64))
    return img, segs, iters, float(iters * lanes)


def _defaults(dev: torch.device, tile_rows, window):
    cuda = dev.type == "cuda"
    tile_rows = tile_rows or (DEF_TILE_ROWS if cuda else CPU_TILE_ROWS)
    if window is None:
        window = DEF_WINDOW if cuda else CPU_WINDOW
    return tile_rows, window


def render_wq_range(scene: T.Scene, cam: Camera, width: int, height: int,
                    samp_base: int, sc: int, *, max_depth: int = 50,
                    attenuate_emission: bool = False, t_min: float = 1e-3,
                    seed: int = 0, tile_rows: Optional[int] = None,
                    window: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> torch.Tensor:
    """Unnormalised framebuffer sums (n_pix, 3) over samples
    [samp_base, samp_base + sc) of every pixel, through the windowed
    driver at any `window` (1 included, as in the reference).  Streams are
    keyed on the global (pixel, sample) pair, so range sums compose
    deterministically."""
    dev = resolve_device(device)
    tile_rows, window = _defaults(dev, tile_rows, window)
    fb, _, _, _ = wq_window_fb(
        scene, cam, width, height, n_pix_loc=width * height, spp_loc=int(sc),
        chunk=pick_chunk(sc), window=window, max_depth=max_depth,
        attenuate=attenuate_emission, t_min=t_min, tile_rows=tile_rows,
        seed=seed, device=dev, samp_base=int(samp_base))
    return fb


def render_wq(scene: T.Scene, cam: Camera, width: int, height: int,
              spp: int, max_depth: int = 50,
              attenuate_emission: bool = False, t_min: float = 1e-3,
              seed: int = 0, tile_rows: Optional[int] = None,
              window: Optional[int] = None, return_stats: bool = False,
              device: Union[str, torch.device] = "cuda"):
    """Render with the work-queue megakernel.  Output (H, W, 3), fb row 0 =
    image bottom (flipped at save, main.cpp:41).  `window` > 1 (the
    default) takes the windowed driver, window <= 1 the one-bounce driver
    (`render_wq_one_bounce`).  With return_stats: (img, traced_segments,
    bounce_iters, lane_steps)."""
    dev = resolve_device(device)
    tile_rows, window = _defaults(dev, tile_rows, window)
    if window <= 1:
        out = render_wq_one_bounce(
            scene, cam, width, height, spp, max_depth=max_depth,
            attenuate=attenuate_emission, t_min=t_min, tile_rows=tile_rows,
            seed=seed, device=dev)
        return out if return_stats else out[0]
    fb, segs, iters, lane_steps = wq_window_fb(
        scene, cam, width, height, n_pix_loc=width * height, spp_loc=spp,
        chunk=pick_chunk(spp), window=window, max_depth=max_depth,
        attenuate=attenuate_emission, t_min=t_min, tile_rows=tile_rows,
        seed=seed, device=dev)
    img = fdiv(fb, float(spp)).reshape(height, width, 3)
    if return_stats:
        return img, segs, iters, lane_steps
    return img
