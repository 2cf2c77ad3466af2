"""Windowed work-queue renderer: the port's production forward path.

Mirrors the reference package's `engine/wq.py`: the windowed driver
(`wq_window_fb`, `render_wq`, `render_wq_range`) and, for
`render_wq(window=1)`, the one-bounce driver (`render_wq_one_bounce`).
Lanes that finish are refilled from a global chunk queue, so no lane idles
behind a long path:

1. refill: dead lanes are granted the next chunk (`chunk` consecutive
   samples of one pixel, pixel-major), seeded with `core.rng`'s
   splitmix32 stream seed, and given their camera ray by
   `integrator.camera_rays`; the finished chunk's radiance is banked in
   one of two per-lane slots;
2. texel service: pending image-texture fixups get their atlas texel,
   S=4 per 128-lane row plus full service for a rotating set of heavy
   rows; uncovered lanes stall in the kernel;
3. bounce: `ops.wave_bounce.wave_bounce`, the CUDA kernel, advances every
   lane one segment and regenerates within the chunk;
4. once per window of `window` bounces the banks are deposited into the
   framebuffer.

The reference's `while_loop` is a host loop here: one device-to-host read
per window for its condition (chunks left, or more live lanes than the
first drain stage holds).  Once the queue is empty the live lanes are
compacted into 4x narrower grids (the drain stages) as they die out.

Deposits add in a fixed order: every contribution to one framebuffer
entry is added sequentially in the order the reference's scatter-adds
take them (bank slot 0's lanes, then slot 1's, each in lane order), via a
stable sort and gathers, with no atomics.  The result is the same on
every run and device and does not depend on thread timing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..core.camera import Camera
from ..core.device import resolve_device
from ..core.rng import INITIAL_STATE, MASK32, f32, splitmix32
from ..core.vec import fdiv
from ..scene import types as T
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
    lane_steps); occupancy = traced_segments / lane_steps."""
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
    vcpp = max(valid_cpp, 1)
    quantum = tile_rows * LANE
    rows = _round_up(min(n_pix_loc, n_pix_loc * spp_loc), quantum) // LANE
    sh = (rows, LANE)
    f32 = torch.float32

    tables = WB.pack_scene(scene, dev)._replace(
        cam=WB.pack_camera(cam, width, height, dev), seed=int(seed) & MASK32)
    atlas_flat, n_atlas = _pack_atlas_flat(scene.textures.atlas.to(dev))

    def step(st, fx, k):
        texel, srv = texel_service(fx, k, atlas_flat, n_atlas)
        out = WB.wave_bounce(tables, st, fix=fx, texel=texel, srv=srv,
                             t_min=t_min, max_depth=max_depth,
                             attenuate=attenuate, tile_rows=tile_rows)
        return out.state, out.fix

    def refill(st: WB.WaveState, ex: WqwExtra, counter: torch.Tensor,
               fx: WB.FixState):
        """Grant dead lanes the next chunk and launch its first camera ray
        (the kernel's in-chunk regeneration continues the same streams);
        bank the finished chunk into a free deposit slot."""
        slot0_free = ex.bpix0 < 0.0
        slot1_free = ex.bpix1 < 0.0
        had_chunk = st.pix >= 0.0
        # a dead lane with a pending EMIT fixup keeps its acc until the
        # texel service covers it (the kernel adds the emission then)
        dead = (st.alive <= 0.0) & (fx.kind != WB.FIX_EMIT)
        elig = dead & (slot0_free | slot1_free | ~had_chunk)
        elig_i = elig.reshape(-1).long()
        rank = torch.cumsum(elig_i, 0) - elig_i          # exclusive prefix
        navail = n_chunks - counter
        grant = (elig.reshape(-1) & (rank < navail)).reshape(sh)
        cid = counter + rank.reshape(sh)
        pix_new = float(pix_base) + torch.div(
            cid, vcpp, rounding_mode="floor").to(f32)
        s0 = float(samp_base) + ((cid % vcpp) * C).to(f32)

        # the stream seed and camera ray of (pix_new, s0), for every lane
        pix_u = pix_new.reshape(-1).long()
        s_u = s0.reshape(-1).long()
        rng0 = splitmix32(pix_u ^ splitmix32(s_u ^ tables.seed))
        rng0 = torch.where(rng0 == 0, torch.full_like(rng0, INITIAL_STATE),
                           rng0)
        rng1, o, d, tmv = camera_rays(cam, width, height, pix_u, rng0)

        do_bank = grant & had_chunk
        use0 = do_bank & slot0_free
        use1 = do_bank & ~slot0_free
        w = torch.where
        ex = WqwExtra(
            bpix0=w(use0, st.pix, ex.bpix0), br0=w(use0, st.accx, ex.br0),
            bg0=w(use0, st.accy, ex.bg0), bb0=w(use0, st.accz, ex.bb0),
            bpix1=w(use1, st.pix, ex.bpix1), br1=w(use1, st.accx, ex.br1),
            bg1=w(use1, st.accy, ex.bg1), bb1=w(use1, st.accz, ex.bb1))
        sel = lambda new, old: w(grant, new.reshape(sh), old)
        st = st._replace(
            ox=sel(o.x, st.ox), oy=sel(o.y, st.oy), oz=sel(o.z, st.oz),
            dx=sel(d.x, st.dx), dy=sel(d.y, st.dy), dz=sel(d.z, st.dz),
            tm=sel(tmv, st.tm), rng=sel(rng1, st.rng),
            tpx=w(grant, 1.0, st.tpx), tpy=w(grant, 1.0, st.tpy),
            tpz=w(grant, 1.0, st.tpz), radx=w(grant, 0.0, st.radx),
            rady=w(grant, 0.0, st.rady), radz=w(grant, 0.0, st.radz),
            alive=w(grant, 1.0, st.alive), bnc=w(grant, 0.0, st.bnc),
            pix=w(grant, pix_new, st.pix), s=w(grant, s0, st.s),
            send=w(grant, s0 + float(C), st.send),
            accx=w(grant, 0.0, st.accx), accy=w(grant, 0.0, st.accy),
            accz=w(grant, 0.0, st.accz))
        return st, ex, counter + torch.minimum(elig_i.sum(), navail)

    def nlive(st, fx):
        # lanes with a pending fixup still owe work or radiance
        return ((st.alive > 0.0) | (fx.kind != 0.0)).sum()

    # drain stages: narrow the grid 4x per stage as the live set decays
    n_tiles = rows // tile_rows
    stage_tiles = []
    t = n_tiles
    while t > 1 and len(stage_tiles) < 3:
        t = max(1, t // 4)
        stage_tiles.append(t)
    caps = [t * quantum for t in stage_tiles]
    cap1 = caps[0] if caps else 0

    st = _zeros_state(rows, dev)
    ex = _zeros_extra(rows, dev)
    fx = WB.zero_fix(rows, dev)
    fb = torch.zeros(3 * n_pix_loc + 1, dtype=f32, device=dev)
    counter = torch.zeros((), dtype=torch.long, device=dev)
    granted, live, wins = 0, 0, 0
    while granted < n_chunks or live > cap1:   # one host read per window
        for k in range(window):
            if granted < n_chunks:      # else every refill is a no-op
                st, ex, counter = refill(st, ex, counter, fx)
            st, fx = step(st, fx, k)
        ex, fb = deposit(ex, fb, n_pix_loc, cpp, pix_base)
        wins += 1
        granted, live = torch.stack([counter, nlive(st, fx)]).tolist()
    iters = wins * window
    lane_steps = float(iters * rows * LANE)

    wrk_tot = 0.0
    for i, stiles in enumerate(stage_tiles):
        wrk_tot += float(st.wrk.sum(dtype=torch.float64))
        fb = flush_acc(st, fb, n_pix_loc, cpp, pix_base)
        st, fx = compact(st, fx, stiles * tile_rows)[:2]
        next_cap = caps[i + 1] if i + 1 < len(caps) else 0
        w2 = 0
        live = int(nlive(st, fx))
        while live > next_cap:
            for k in range(window):
                st, fx = step(st, fx, k)
            w2 += 1
            live = int(nlive(st, fx))
        iters += w2 * window
        lane_steps += float(w2 * window * stiles * tile_rows * LANE)

    # residual flush: each lane's last chunk was never re-granted
    fb = flush_acc(st, fb, n_pix_loc, cpp, pix_base)
    segs = wrk_tot + float(st.wrk.sum(dtype=torch.float64))
    fb3 = fb[:3 * n_pix_loc].reshape(3, n_pix_loc).transpose(0, 1)
    return fb3, segs, iters, lane_steps


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

    tables = WB.pack_scene(scene, dev)._replace(
        cam=WB.pack_camera(cam, width, height, dev), seed=int(seed) & MASK32)
    atlas_flat, n_atlas = _pack_atlas_flat(scene.textures.atlas.to(dev))
    w = torch.where

    def refill(st: WB.WaveState, counter: torch.Tensor):
        """Grant dead lanes the next sample ids and launch their camera
        rays, seeded splitmix(pix ^ splitmix(k ^ seed)), never 0, as the
        kernel's regeneration seeds them.  send = s: the kernel's in-chunk
        regeneration never fires; the queue is the only sample source."""
        dead = (st.alive <= 0.0).reshape(-1)
        dead_i = dead.long()
        rank = torch.cumsum(dead_i, 0) - dead_i          # exclusive prefix
        navail = total - counter
        grant = (dead & (rank < navail)).reshape(sh)
        sid = counter + rank
        pix_new = torch.div(sid, spp, rounding_mode="floor")
        k_new = sid - pix_new * spp
        rng0 = splitmix32(pix_new ^ splitmix32(k_new ^ tables.seed))
        rng0 = w(rng0 == 0, torch.full_like(rng0, INITIAL_STATE), rng0)
        rng1, o, d, tmv = camera_rays(cam, width, height, pix_new, rng0)
        sel = lambda new, old: w(grant, new.reshape(sh), old)
        k_f = k_new.to(torch.float32)
        st = st._replace(
            ox=sel(o.x, st.ox), oy=sel(o.y, st.oy), oz=sel(o.z, st.oz),
            dx=sel(d.x, st.dx), dy=sel(d.y, st.dy), dz=sel(d.z, st.dz),
            tm=sel(tmv, st.tm), rng=sel(rng1, st.rng),
            tpx=w(grant, 1.0, st.tpx), tpy=w(grant, 1.0, st.tpy),
            tpz=w(grant, 1.0, st.tpz), radx=w(grant, 0.0, st.radx),
            rady=w(grant, 0.0, st.rady), radz=w(grant, 0.0, st.radz),
            alive=w(grant, 1.0, st.alive), s=sel(k_f, st.s),
            bnc=w(grant, 0.0, st.bnc),
            pix=sel(pix_new.to(torch.float32), st.pix), send=sel(k_f, st.send))
        return st, counter + torch.minimum(dead_i.sum(), navail)

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
