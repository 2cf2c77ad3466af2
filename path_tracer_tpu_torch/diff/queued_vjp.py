"""Gradients by record and replay over the work queue.

Mirrors the reference package's `diff/queued_vjp.py`:

* **Forward** (`record_forward_q`) is the work-queue render of
  `engine.wq`: lanes pull (pixel, sample-chunk) grants from a global
  queue, the bounce kernel (`ops.wave_bounce.wave_bounce`, the CUDA kernel
  on CUDA tensors) advances every live lane each step, finished chunks
  bank into two per-lane slots that flush to the framebuffer once a
  window, and image texels come from the bounded texel service.  Every
  step records, per lane, the (pixel, sample) it traced, the winner record
  `win` and `t_hit` the kernel emits, the incoming direction and the
  texel fixup it applied.  The schedule is static, in two stages: a
  full-width stage sized to drain the sample queue, then the surviving
  paths compacted into a narrow grid (the permutation is recorded), their
  not-yet-started samples re-queued as single-sample grants.  No window
  reads the device from the host; `ok` says whether the schedule finished
  the work.
* **Backward** is autograd through `replay_fb`, a differentiable replay
  that rebuilds the framebuffer from the records: every discrete decision
  (winner, dielectric branch, medium acceptance, random draws) is pinned
  to the recorded path and the continuous quantities along it are
  recomputed from the scene and camera tensors.  The winner's attributes
  come from a direct index gather into a table indexed by scan id
  (`build_attr_table`); autograd scatter-adds the cotangents back.  Each
  window of the replay is rematerialised in the backward pass
  (`torch.utils.checkpoint`), so only the window carries are stored.
* `render_grad_fb` wraps the two in a `torch.autograd.Function`.

Box sides share one scan id (box.hpp:20-25), so the winner record cannot
name the side: rect rows of the table hold the six axis-plane constants
(min and max per axis over the sides) and the replay takes the plane
whose t matches the recorded t.  Material columns of a box are written by
one representative side only: every duplicate of an index_put gets the
full cotangent of its cell, which would count shared parameters six
times.

Reference semantics being differentiated: render.hpp:25-106,
material.hpp:11-131, sphere.hpp:59-106, rectangle.hpp:16-130,
triangle.hpp:58-100, constant_medium.hpp:28-77, camera.hpp:93-100,
texture.hpp:18-151.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..core.camera import Camera
from ..core.device import resolve_device
from ..core.rng import INITIAL_STATE, MASK32, f32, splitmix32
from ..core.vec import Vec3, frsqrt, fsin, fsqrt
from ..engine import wq as WQ
from ..engine.integrator import camera_rays
from ..ops import wave_bounce as WB
from ..scene import types as T
from .params import combine, leaves, partition, with_leaves

LANE = WB.LANE
F32 = torch.float32
INV255 = f32(1.0 / 255.0)
T_MIN = 1e-3          # the reference's ray-epsilon default
SEED = 0              # the reference's render seed default
AVG_PATH_HINT = 3.0   # mean segments a path the schedule is sized for


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# Recording work-queue forward
# ---------------------------------------------------------------------------

class ResQ(NamedTuple):
    """Per-step records of one stage, all (S, lanes): float32, texel int32.

    win: ((term*4 + cls)*1024 + scan) + 1, 0 = the lane did not advance
    (dead or stalled).  pix/s: the (pixel, sample) traced at this step.
    fresh: 1 where this step starts a new sample's path.  fixk/texel: the
    image-texture fixup applied at the start of this step (0 none,
    1 albedo, 2 emit) and its atlas texel."""
    pix: torch.Tensor
    s: torch.Tensor
    fresh: torch.Tensor
    win: torch.Tensor
    t: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    texel: torch.Tensor
    fixk: torch.Tensor


class RecQ(NamedTuple):
    """Two-stage recording: full-width stage `a`, drain stage `b` on lanes
    compacted through `perm` (int64 stage-A flat lane of each stage-B
    lane; `pvalid` masks the real entries)."""
    a: ResQ
    b: ResQ
    perm: torch.Tensor
    pvalid: torch.Tensor


def rec_segments(rec: RecQ) -> torch.Tensor:
    """Traced path segments in the recording (float32 0-d tensor)."""
    return ((rec.a.win > 0).sum() + (rec.b.win > 0).sum()).to(F32)


def record_forward_q(scene: T.Scene, cam: Camera, width: int, height: int,
                     pix_base: int, samp_base: int, *, npx: int, spp: int,
                     max_depth: int, attenuate: bool, t_min: float,
                     seed: int, rows: int, rows_b: int, tile_rows: int,
                     tile_rows_b: int, window: int, chunk: int,
                     n_windows: int, n_windows_b: int,
                     device: Union[str, torch.device], tail_pix: int = 0
                     ) -> Tuple[torch.Tensor, RecQ, torch.Tensor]:
    """Trace samples [samp_base, samp_base+spp) of pixels
    [pix_base, pix_base+npx) through the work-queue kernel, recording
    per-step residuals.  Returns (fb (npx, 3) radiance sums over spp,
    RecQ, ok): ok (a 0-d bool tensor) is False iff the static schedule
    could not finish the work (queue not drained, paths alive at the end,
    or more survivors at the stage boundary than stage B holds); fb and
    gradients are then partial.  Work order and streams are the work-queue
    driver's, so per-sample radiance matches `engine.wq` up to deposit
    reassociation.

    The last `tail_pix` pixels are granted as single-sample chunks: a
    C-sample chunk is a serial chain of up to C*max_depth steps on one
    lane, and chains granted near the queue's end set the drain's length.
    Streams are keyed on (pixel, sample), so this changes no radiance."""
    dev = resolve_device(device)
    C = chunk
    cpp = spp // C
    if cpp * C != spp:
        raise ValueError(f"chunk {C} must divide spp {spp}")
    tail_pix = min(int(tail_pix), npx)
    head_pix = npx - tail_pix
    head_chunks = head_pix * cpp
    n_chunks = head_chunks + tail_pix * spp
    pix_base_f = float(pix_base)
    samp_base_f = float(samp_base)

    tables = WB.pack_scene(scene, dev)._replace(
        cam=WB.pack_camera(cam, width, height, dev), seed=int(seed) & MASK32)
    atlas_flat, n_atlas = WQ._pack_atlas_flat(scene.textures.atlas.to(dev))
    w = torch.where

    def refill(st: WB.WaveState, ex: WQ.WqwExtra, counter, fx, lo=None):
        """The work-queue refill: grant dead lanes the next pixel-major
        chunk and bank the finished chunk into a free deposit slot.  `lo`
        is stage B's leftover-singles queue (lo_pix, lo_s, n_lo): chunk
        ids past the main queue map into it."""
        sh = st.ox.shape
        slot0_free = ex.bpix0 < 0.0
        slot1_free = ex.bpix1 < 0.0
        had_chunk = st.pix >= 0.0
        dead = (st.alive <= 0.0) & (fx.kind != WB.FIX_EMIT)
        elig = dead & (slot0_free | slot1_free | ~had_chunk)
        elig_i = elig.reshape(-1).long()
        rank = torch.cumsum(elig_i, 0) - elig_i
        n_total = n_chunks if lo is None else n_chunks + lo[2]
        navail = n_total - counter
        grant = (elig.reshape(-1) & (rank < navail)).reshape(sh)
        cid = counter + rank.reshape(sh)
        in_tail = cid >= head_chunks
        j = torch.clamp(cid - head_chunks, min=0)
        fl = lambda a, b: torch.div(a, b, rounding_mode="floor")
        pix_new = pix_base_f + w(in_tail, head_pix + fl(j, spp),
                                 fl(cid, cpp)).to(F32)
        s0 = samp_base_f + w(in_tail, j % spp, (cid % cpp) * C).to(F32)
        clen = w(in_tail, 1.0, float(C))
        if lo is not None:
            lo_pix, lo_s, _ = lo
            in_lo = cid >= n_chunks
            li = torch.clamp(cid - n_chunks, 0, lo_pix.shape[0] - 1)
            pix_new = w(in_lo, lo_pix[li], pix_new)
            s0 = w(in_lo, lo_s[li], s0)
            clen = w(in_lo, 1.0, clen)

        pix_u = pix_new.reshape(-1).long()
        s_u = s0.reshape(-1).long()
        rng0 = splitmix32(pix_u ^ splitmix32(s_u ^ tables.seed))
        rng0 = w(rng0 == 0, torch.full_like(rng0, INITIAL_STATE), rng0)
        rng1, o, d, tmv = camera_rays(cam, width, height, pix_u, rng0)

        do_bank = grant & had_chunk
        use0 = do_bank & slot0_free
        use1 = do_bank & ~slot0_free
        ex = WQ.WqwExtra(
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
            send=w(grant, s0 + clen, st.send),
            accx=w(grant, 0.0, st.accx), accy=w(grant, 0.0, st.accy),
            accz=w(grant, 0.0, st.accz))
        return st, ex, counter + torch.minimum(elig_i.sum(), navail)

    # a pixel takes at most one deposit a chunk, so at most spp
    deposit = lambda ex, fb: WQ.deposit(ex, fb, npx, spp, pix_base_f)
    flush_acc = lambda st, fb: WQ.flush_acc(st, fb, npx, spp, pix_base_f)

    def run_stage(carry, fb, n_win, k0, tr, dense_fix, lo=None):
        st, ex, counter, fx, ppix, ps = carry
        lanes = st.ox.numel()
        S = n_win * window
        recs = [torch.empty((S, lanes), dtype=torch.int32 if name == "texel"
                            else F32, device=dev) for name in ResQ._fields]
        for k in range(S):
            st, ex, counter = refill(st, ex, counter, fx, lo)
            fresh = ((st.s != ps) | (st.pix != ppix)) & (st.alive > 0.0)
            if dense_fix:
                idx = torch.clamp(fx.idx.long(), 0, n_atlas - 1)
                texel = atlas_flat[idx]
                srv = torch.ones_like(fx.kind)
            else:
                texel, srv = WQ.texel_service(fx, k0 + k, atlas_flat, n_atlas)
            out = WB.wave_bounce(tables, st, fix=fx, texel=texel, srv=srv,
                                 t_min=t_min, max_depth=max_depth,
                                 attenuate=attenuate, tile_rows=tr)
            for r, v in zip(recs, (st.pix, st.s, fresh, out.win, out.t_hit,
                                   st.dx, st.dy, st.dz, texel,
                                   fx.kind * srv)):
                r[k] = v.reshape(-1)
            ppix, ps = st.pix, st.s
            st, fx = out.state, out.fix
            if (k + 1) % window == 0:
                ex, fb = deposit(ex, fb)
        return (st, ex, counter, fx, ppix, ps), fb, ResQ(*recs)

    # ---- stage A: full width ---------------------------------------------
    neg = torch.full((rows, LANE), -1.0, dtype=F32, device=dev)
    carry = (WQ._zeros_state(rows, dev), WQ._zeros_extra(rows, dev),
             torch.zeros((), dtype=torch.long, device=dev),
             WB.zero_fix(rows, dev), neg, neg)
    fb = torch.zeros(3 * npx + 1, dtype=F32, device=dev)
    carry, fb, res_a = run_stage(carry, fb, n_windows, 0, tile_rows, False)
    st, ex, counter, fx, ppix, ps = carry

    # ---- boundary: flush, compact ----------------------------------------
    ex, fb = deposit(ex, fb)
    fb = flush_acc(st, fb)
    st, fx, perm, pvalid, nlive = WQ.compact(st, fx, rows_b)
    ppix, ps = (w(pvalid, v.reshape(-1)[perm].reshape(pvalid.shape), -1.0)
                for v in (ppix, ps))

    # ---- boundary: split the surviving chunks ------------------------------
    # The current sample keeps its lane; the chunk's not-yet-started
    # samples re-queue as single-sample grants any idle drain lane can
    # pick up (streams are keyed on (pixel, sample): no radiance changes).
    lo = None
    if C > 1:
        qcap = (C - 1) * rows_b * LANE
        valid_b = (st.s >= 0.0).reshape(-1)
        m_all = torch.cat([valid_b & ((st.s + float(jj)) < st.send).reshape(-1)
                           for jj in range(1, C)])
        m_i = m_all.long()
        r = torch.cumsum(m_i, 0) - m_i
        tgt = w(m_all & (r < qcap), r, qcap)
        zq = torch.zeros(qcap + 1, dtype=F32, device=dev)
        lo_pix = zq.scatter(0, tgt, st.pix.reshape(-1).repeat(C - 1))[:qcap]
        lo_s = zq.scatter(0, tgt, torch.cat(
            [(st.s + float(jj)).reshape(-1) for jj in range(1, C)]))[:qcap]
        lo = (lo_pix, lo_s, m_i.sum())
        st = st._replace(send=w(st.s >= 0.0,
                                torch.minimum(st.send, st.s + 1.0), st.send))

    # ---- stage B: narrow drain, every pending fixup serviced ---------------
    carry = (st, WQ._zeros_extra(rows_b, dev), counter, fx, ppix, ps)
    carry, fb, res_b = run_stage(carry, fb, n_windows_b, n_windows * window,
                                 tile_rows_b, True, lo)
    st, ex, counter, fx, _, _ = carry
    ex, fb = deposit(ex, fb)
    fb = flush_acc(st, fb)

    n_work = n_chunks if lo is None else n_chunks + lo[2]
    ok = ((counter >= n_work) & ~(st.alive > 0.0).any()
          & (fx.kind == 0.0).all() & (nlive <= rows_b * LANE))
    rec = RecQ(a=res_a, b=res_b, perm=perm, pvalid=pvalid.reshape(-1))
    return fb[:3 * npx].reshape(3, npx).transpose(0, 1), rec, ok


# ---------------------------------------------------------------------------
# Scan-indexed attribute table
# ---------------------------------------------------------------------------

# Main-table columns (A = 27); triangles and media keep side tables.
_C_SPH = 0     # c0x c0y c0z dcx dcy dcz t0 inv_dt radius           (0-8)
_C_RECT = 9    # x0 x1 y0 y1 z0 z1  (axis-plane constants/bounds)   (9-14)
_C_MAT = 15    # mtype param colx coly colz                         (15-19)
_C_TEX = 20    # ttype t1x t1y t1z t2x t2y t2z                      (20-26)
_A = 27
_A_TRI = 9     # v0x v0y v0z e1x e1y e1z e2x e2y e2z
_A_MED = 12    # btype cx cy cz r pmnx pmny pmnz pmxx pmxy pmxz nid
_MAX_SCAN = 1024   # scan ids the win record can carry


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[idx] with indices clamped into range (jnp.take mode="clip")."""
    return a[torch.clamp(idx.long(), 0, a.shape[0] - 1)]


def _mat_cols(scene: T.Scene, mat_idx: torch.Tensor):
    """The 12 material/texture columns of a primitive array."""
    m, tx = scene.materials, scene.textures
    tex = _take(m.tex, mat_idx)
    return [_take(m.mtype, mat_idx).to(F32), _take(m.param, mat_idx),
            *(_take(c, mat_idx) for c in m.color),
            _take(tx.ttype, tex).to(F32),
            *(_take(c, tex) for c in tx.c1), *(_take(c, tex) for c in tx.c2)]


def attr_table_rows(scene: T.Scene, attr_rows: Optional[int] = None) -> int:
    """Static row count of the scan-indexed table: from the padded class
    sizes, or from the `attr_rows` hint (`static_attr_rows`)."""
    if attr_rows is None:
        attr_rows = (scene.spheres.radius.shape[0] + scene.rects.k.shape[0]
                     + scene.triangles.scan.shape[0] + scene.media.r.shape[0])
    return min(_MAX_SCAN, _round_up(max(attr_rows, LANE), LANE))


def static_attr_rows(scene: T.Scene) -> int:
    """max active scan id + 1 of a scene: the tight `attr_rows` hint."""
    m = 0
    for cls in (scene.spheres, scene.rects, scene.triangles, scene.media):
        a = cls.scan[cls.active]
        if a.numel():
            m = max(m, int(a.max()) + 1)
    return max(m, 1)


def check_attr_rows(scene: T.Scene, attr_rows: Optional[int] = None) -> None:
    """Raise ValueError when the scan-indexed table would hold fewer rows
    than the scene's scan ids need: a too-small `attr_rows` hint, or a
    scene past the `_MAX_SCAN` ids the win record carries.  The reference
    sends such primitives to the drop row, and its replay then fetches
    zeros for them without a word."""
    need, have = static_attr_rows(scene), attr_table_rows(scene, attr_rows)
    if have < need:
        raise ValueError(
            f"the attribute table holds {have} rows but the scene's scan ids "
            f"need {need} (attr_rows={attr_rows}, at most {_MAX_SCAN} scan "
            f"ids)")


def build_attr_table(scene: T.Scene, attr_rows: Optional[int] = None):
    """Winner-attribute tables indexed by global scan id: the (R, 27) main
    table plus the (n_tri, 9) and (n_med, 12) side tables with their scan
    ids (-1 for padding).  Differentiable w.r.t. every float scene leaf
    it reads."""
    R = attr_table_rows(scene, attr_rows)
    dev = scene.spheres.radius.device
    cols = [torch.zeros(R + 1, dtype=F32, device=dev) for _ in range(_A)]

    def rowset(idx, col0, vals):
        """Rows idx of columns col0.. set to vals (row R is the drop
        slot, so its duplicates are harmless)."""
        for j, v in enumerate(vals):
            cols[col0 + j] = cols[col0 + j].index_put((idx,), v.to(F32))

    def scan_rows(cls, mask):
        return torch.where(mask, torch.clamp(cls.scan.long(), 0, R), R)

    sph = scene.spheres
    i_s = scan_rows(sph, sph.active)
    dt = sph.time1 - sph.time0
    inv_dt = torch.where(dt == 0.0, 0.0,
                         1.0 / torch.where(dt == 0.0, 1.0, dt))
    rowset(i_s, _C_SPH, [*sph.c0, *(b - a for a, b in zip(sph.c0, sph.c1)),
                         sph.time0, inv_dt, sph.radius])
    rowset(i_s, _C_MAT, _mat_cols(scene, sph.mat))

    # rects: per-axis plane constants by scatter-min/max over box sides
    r = scene.rects
    i_r = scan_rows(r, r.active)
    is_xy, is_xz, is_yz = (r.axis == T.RECT_XY, r.axis == T.RECT_XZ,
                           r.axis == T.RECT_YZ)
    ext = ((torch.where(is_yz, r.k, r.a0), torch.where(is_yz, r.k, r.a1)),
           (torch.where(is_xz, r.k, torch.where(is_xy, r.b0, r.a0)),
            torch.where(is_xz, r.k, torch.where(is_xy, r.b1, r.a1))),
           (torch.where(is_xy, r.k, r.b0), torch.where(is_xy, r.k, r.b1)))
    for j, (vlo, vhi) in enumerate(ext):
        for side, (v, how, init) in enumerate(((vlo, "amin", math.inf),
                                               (vhi, "amax", -math.inf))):
            c = torch.full((R + 1,), init, dtype=F32, device=dev)
            c = c.scatter_reduce(0, i_r, v, how, include_self=False)
            cols[_C_RECT + 2 * j + side] = torch.where(torch.isfinite(c), c,
                                                       0.0)
    # material columns from ONE representative side
    rowset(scan_rows(r, r.active & (r.sub == 0)), _C_MAT,
           _mat_cols(scene, r.mat))

    tr = scene.triangles
    rowset(scan_rows(tr, tr.active), _C_MAT, _mat_cols(scene, tr.mat))
    tri_tab = torch.stack(
        [*tr.v0, *(b - a for a, b in zip(tr.v0, tr.v1)),
         *(b - a for a, b in zip(tr.v0, tr.v2))], dim=1)
    tri_ids = torch.where(tr.active, tr.scan.long(), -1)

    md = scene.media
    rowset(scan_rows(md, md.active), _C_MAT, _mat_cols(scene, md.mat))
    med_tab = torch.stack([md.btype.to(F32), *md.c, md.r, *md.pmin,
                           *md.pmax, md.neg_inv_density], dim=1)
    med_ids = torch.where(md.active, md.scan.long(), -1)

    tab = torch.stack(cols, dim=1)[:R]
    return tab, tri_tab, tri_ids, med_tab, med_ids


# ---------------------------------------------------------------------------
# Differentiable replay
# ---------------------------------------------------------------------------

# the replay's per-lane carry, in order
CARRY = ("ox", "oy", "oz", "dx", "dy", "dz", "tm", "tpx", "tpy", "tpz",
         "pex", "pey", "pez", "ax", "ay", "az", "ppix",
         "b0p", "b0r", "b0g", "b0b", "b1p", "b1r", "b1g", "b1b")
_N_PATH = 13       # ox .. pez: the path state a compaction carries over


def _zeros_carry(lanes: int, dev) -> Tuple[torch.Tensor, ...]:
    z = torch.zeros(lanes, dtype=F32, device=dev)
    one = torch.ones(lanes, dtype=F32, device=dev)
    neg = torch.full((lanes,), -1.0, dtype=F32, device=dev)
    return (z, z, z, z, z, one, z, one, one, one,
            z, z, z, z, z, z, neg,
            neg, z, z, z, neg, z, z, z)


def _decode(res: ResQ, R: int, tri_row: torch.Tensor,
            med_row: torch.Tensor):
    """A stage's win records decoded for the replay, all (S, lanes):
    live, term, cls and the gather rows of the main, tri and media
    tables (each table's last row is zeros: no such primitive)."""
    live = res.win > 0.0
    enc = torch.clamp(res.win - 1.0, min=0.0)
    term = torch.floor(enc * (1.0 / 4096.0))
    rem = enc - term * 4096.0
    cls = torch.floor(rem * (1.0 / 1024.0))
    scan = (rem - cls * 1024.0).long()
    i_main = torch.where(scan < R, scan, R)
    return live, term, cls, i_main, tri_row[scan], med_row[scan]


def _scan_map(ids: torch.Tensor) -> torch.Tensor:
    """(1024,) scan id -> row of the side table, n (its zero row) where no
    active primitive has that id."""
    n = ids.shape[0]
    m = torch.full((_MAX_SCAN + 1,), n, dtype=torch.long, device=ids.device)
    slot = torch.where(ids >= 0, ids, _MAX_SCAN)
    return m.scatter(0, slot, torch.arange(n, device=ids.device))[:_MAX_SCAN]


def _replay_step(tab, tri_tab, med_tab, cam: Camera, width: int,
                 height: int, seed: int, attenuate: bool, t_min: float,
                 carry, xs):
    """One recorded step for every lane, differentiable in the tables and
    the camera.  Radiance accumulates per lane (ax/ay/az) and banks into
    the two per-lane deposit slots (b0*/b1*) when the lane's pixel
    changes; the recorder granted only with a free slot and flushes both
    every window, so two slots suffice here too."""
    (ox, oy, oz, dx, dy, dz, tm, tpx, tpy, tpz, pex, pey, pez, ax, ay, az,
     ppix, b0p, b0r, b0g, b0b, b1p, b1r, b1g, b1b) = carry
    (pix, s, fresh, live, term, cls, i_main, i_tri, i_med, t_rec,
     dnx, dny, dnz, texel, fixk) = xs
    w = torch.where

    # ---- pixel change: bank the finished chunk's radiance ----------------
    pixc = pix != ppix
    bank = pixc & (ppix >= 0.0)
    slot0_free = b0p < 0.0
    use0 = bank & slot0_free
    use1 = bank & ~slot0_free
    b0p, b0r, b0g, b0b = (w(use0, n, o) for n, o in
                          ((ppix, b0p), (ax, b0r), (ay, b0g), (az, b0b)))
    b1p, b1r, b1g, b1b = (w(use1, n, o) for n, o in
                          ((ppix, b1p), (ax, b1r), (ay, b1g), (az, b1b)))
    ax, ay, az = (w(pixc, 0.0, v) for v in (ax, ay, az))

    # ---- fresh path start: differentiable camera ray ---------------------
    pix_u = torch.clamp(pix, min=0.0).long()
    s_u = torch.clamp(s, min=0.0).long()
    rng0 = splitmix32(pix_u ^ splitmix32(s_u ^ seed))
    rng0 = w(rng0 == 0, torch.full_like(rng0, INITIAL_STATE), rng0)
    _, o0, d0, tm0 = camera_rays(cam, width, height, pix_u, rng0)
    frs = fresh > 0.0
    ox, oy, oz, dx, dy, dz, tm = (w(frs, n, o) for n, o in (
        (o0.x, ox), (o0.y, oy), (o0.z, oz), (d0.x, dx), (d0.y, dy),
        (d0.z, dz), (tm0, tm)))
    tpx, tpy, tpz = (w(frs, 1.0, v) for v in (tpx, tpy, tpz))

    # ---- this step's image-texture fixup (texture.hpp:144-150) -----------
    txr = (texel & 0xFF).to(F32) * INV255
    txg = ((texel >> 8) & 0xFF).to(F32) * INV255
    txb = ((texel >> 16) & 0xFF).to(F32) * INV255
    is_alb_fix = fixk == WB.FIX_ALBEDO
    is_emit_fix = fixk == WB.FIX_EMIT
    tpx = w(is_alb_fix, tpx * txr, tpx)
    tpy = w(is_alb_fix, tpy * txg, tpy)
    tpz = w(is_alb_fix, tpz * txb, tpz)
    ax = ax + w(is_emit_fix, pex * txr, 0.0)
    ay = ay + w(is_emit_fix, pey * txg, 0.0)
    az = az + w(is_emit_fix, pez * txb, 0.0)

    # ---- the winner's class and attributes (direct gathers) --------------
    hit = live & (term != 1.0)
    cont = live & (term == 0.0)
    is_s = hit & (cls == 0.0)
    is_r = hit & (cls == 1.0)
    is_t = hit & (cls == 2.0)
    is_m = hit & (cls == 3.0)
    col = tab[i_main].unbind(1)
    colt = tri_tab[i_tri].unbind(1)
    colm = med_tab[i_med].unbind(1)

    a = dx * dx + dy * dy + dz * dz
    a_safe = w(a == 0.0, 1.0, a)
    inv_len = frsqrt(a_safe)    # rsqrt, rounded alike on every device
    udx, udy, udz = dx * inv_len, dy * inv_len, dz * inv_len

    # sphere, moving centre at tm (sphere.hpp:26-117)
    frac = (tm - col[_C_SPH + 6]) * col[_C_SPH + 7]
    cx = col[_C_SPH + 0] + frac * col[_C_SPH + 3]
    cy = col[_C_SPH + 1] + frac * col[_C_SPH + 4]
    cz = col[_C_SPH + 2] + frac * col[_C_SPH + 5]
    srad = col[_C_SPH + 8]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - srad * srad
    disc = b * b - a_safe * cc
    pos = disc > 0.0
    sq = fsqrt(w(pos, disc, 1.0)) * pos.to(F32)
    k1 = (-b - sq) / a_safe
    k2 = (-b + sq) / a_safe
    pick1 = (k1 - t_rec).abs() <= (k2 - t_rec).abs()
    t_sph = w(pick1, k1, k2)

    # rect/box: the axis plane whose t matches the record
    t_rect = torch.zeros_like(a)
    best = torch.full_like(a, math.inf)
    axis = torch.zeros_like(a)
    for j, (ov, dv) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
        dv_ = w(dv == 0.0, 1.0, dv)
        for side in (0, 1):
            tt_ = (col[_C_RECT + 2 * j + side] - ov) / dv_
            dlt = (tt_ - t_rec).abs().detach()
            upd = dlt < best
            best = w(upd, dlt, best)
            t_rect = w(upd, tt_, t_rect)
            axis = w(upd, float(j), axis)
    n_rx, n_ry, n_rz = ((axis == float(j)).to(F32) for j in range(3))

    # triangle (Moller-Trumbore; triangle.hpp:58-100)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = colt
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det = w(det == 0.0, 1.0, det)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    t_tri = (e2x * qvx + e2y * qvy + e2z * qvz) / det

    # medium event (constant_medium.hpp:28-77): t = t1c + nid*logu/|d|
    mb = colm[0].detach()
    mcx, mcy, mcz, mr = colm[1], colm[2], colm[3], colm[4]
    mocx, mocy, mocz = ox - mcx, oy - mcy, oz - mcz
    mbq = mocx * dx + mocy * dy + mocz * dz
    mcc = mocx * mocx + mocy * mocy + mocz * mocz - mr * mr
    mdisc = mbq * mbq - a_safe * mcc
    mpos = mdisc > 0.0
    msq = fsqrt(w(mpos, mdisc, 1.0)) * mpos.to(F32)
    ment_s = (-mbq - msq) / a_safe
    pmnx, pmny, pmnz, pmxx, pmxy, pmxz = colm[5:11]
    ent_b = torch.full_like(a, math.inf)
    for kk_, ov, dv, oav, dav, a0_, a1_, obv, dbv, b0_, b1_ in (
            (pmxz, oz, dz, ox, dx, pmnx, pmxx, oy, dy, pmny, pmxy),
            (pmnz, oz, dz, ox, dx, pmnx, pmxx, oy, dy, pmny, pmxy),
            (pmxy, oy, dy, ox, dx, pmnx, pmxx, oz, dz, pmnz, pmxz),
            (pmny, oy, dy, ox, dx, pmnx, pmxx, oz, dz, pmnz, pmxz),
            (pmxx, ox, dx, oy, dy, pmny, pmxy, oz, dz, pmnz, pmxz),
            (pmnx, ox, dx, oy, dy, pmny, pmxy, oz, dz, pmnz, pmxz)):
        dv_ = w(dv == 0.0, 1.0, dv)
        tt_ = (kk_ - ov) / dv_
        av = oav + tt_ * dav
        bv = obv + tt_ * dbv
        okb = ((av >= a0_) & (av <= a1_) & (bv >= b0_) & (bv <= b1_)
               & (dv != 0.0))
        ent_b = torch.minimum(ent_b, w(okb, tt_, math.inf))
    ment = w(mb == float(T.MED_BOUND_BOX), ent_b, ment_s)
    t1c = torch.clamp(torch.clamp(ment, min=f32(t_min)), min=0.0)
    t1c = w(torch.isfinite(t1c), t1c, 0.0)
    ray_len = fsqrt(a_safe)
    nid = colm[11]
    nid_safe = w(nid == 0.0, -1.0, nid)
    logu = ((t_rec - t1c) * ray_len / nid_safe).detach()
    t_med = t1c + nid_safe * logu * inv_len

    t_hit = w(is_s, t_sph, w(is_r, t_rect, w(is_t, t_tri, t_med)))
    t_hit = w(hit, t_hit, 0.0)
    px_ = ox + t_hit * dx
    py_ = oy + t_hit * dy
    pz_ = oz + t_hit * dz

    # normal, front-flipped with the recorded orientation
    srad_safe = w(srad == 0.0, 1.0, srad)
    n_sx = (px_ - cx) / srad_safe
    n_sy = (py_ - cy) / srad_safe
    n_sz = (pz_ - cz) / srad_safe
    n_tx = e1y * e2z - e1z * e2y
    n_ty = e1z * e2x - e1x * e2z
    n_tz = e1x * e2y - e1y * e2x
    nx = w(is_s, n_sx, w(is_r, n_rx, w(is_t, n_tx, 1.0)))
    ny = w(is_s, n_sy, w(is_r, n_ry, w(is_t, n_ty, 0.0)))
    nz = w(is_s, n_sz, w(is_r, n_rz, w(is_t, n_tz, 0.0)))
    front = is_m | ((dx * nx + dy * ny + dz * nz) < 0.0)
    fsign = w(front, 1.0, -1.0)
    nx, ny, nz = nx * fsign, ny * fsign, nz * fsign

    # ---- winner material and albedo (material.hpp, texture.hpp) ----------
    mtype = col[_C_MAT + 0].detach()
    mpar = col[_C_MAT + 1]
    mcolx, mcoly, mcolz = col[_C_MAT + 2:_C_MAT + 5]
    ttype = col[_C_TEX + 0].detach()
    is_lam = mtype == float(T.MAT_LAMBERTIAN)
    is_metal = mtype == float(T.MAT_METAL)
    is_diel = mtype == float(T.MAT_DIELECTRIC)
    is_light = mtype == float(T.MAT_LIGHT)
    is_plain = is_metal | is_diel
    is_img = (ttype == float(T.TEX_IMAGE)) & ~is_plain
    is_chk = (ttype == float(T.TEX_CHECKER)) & ~is_plain
    with torch.no_grad():
        odd = (fsin(10.0 * px_) * fsin(10.0 * py_) * fsin(10.0 * pz_)) < 0.0
    alb = []
    for c1, c2, mc in zip(col[_C_TEX + 1:_C_TEX + 4],
                          col[_C_TEX + 4:_C_TEX + 7], (mcolx, mcoly, mcolz)):
        v = w(is_chk, w(odd, c1, c2), c1)
        alb.append(w(is_plain, mc, w(is_img, 1.0, v)))
    alb_x, alb_y, alb_z = alb

    # ---- scatter reconstruction (detached draws) -------------------------
    ud_dot_n = udx * nx + udy * ny + udz * nz
    rfl_x = udx - 2.0 * ud_dot_n * nx
    rfl_y = udy - 2.0 * ud_dot_n * ny
    rfl_z = udz - 2.0 * ud_dot_n * nz

    # lambertian: d' = n + unit (the unit vector detached from the record)
    dl_x = nx + (dnx - nx.detach())
    dl_y = ny + (dny - ny.detach())
    dl_z = nz + (dnz - nz.detach())

    # metal: d' = reflect + fuzz * ball
    fz = mpar
    fz_safe = w(fz == 0.0, 1.0, fz).detach()
    bx = ((dnx - rfl_x) / fz_safe).detach()
    by = ((dny - rfl_y) / fz_safe).detach()
    bz = ((dnz - rfl_z) / fz_safe).detach()
    dm_x, dm_y, dm_z = rfl_x + fz * bx, rfl_y + fz * by, rfl_z + fz * bz

    # dielectric: pinned branch, refraction differentiable in ior and n
    ior = w(is_diel, mpar, 1.5)
    ratio = w(front, 1.0 / ior, ior)
    cos_t = torch.clamp(-ud_dot_n, max=1.0)
    chose_reflect = (dnx * nx + dny * ny + dnz * nz) > 0.0
    rp_x = (udx + cos_t * nx) * ratio
    rp_y = (udy + cos_t * ny) * ratio
    rp_z = (udz + cos_t * nz) * ratio
    rp_sq = rp_x * rp_x + rp_y * rp_y + rp_z * rp_z
    rps = (1.0 - rp_sq).abs()
    rpos = rps > 0.0
    rpar_ = -fsqrt(w(rpos, rps, 1.0)) * rpos.to(F32)
    dd_x = w(chose_reflect, rfl_x, rp_x + rpar_ * nx)
    dd_y = w(chose_reflect, rfl_y, rp_y + rpar_ * ny)
    dd_z = w(chose_reflect, rfl_z, rp_z + rpar_ * nz)

    nd_x = w(is_lam, dl_x, w(is_metal, dm_x, w(is_diel, dd_x, dnx)))
    nd_y = w(is_lam, dl_y, w(is_metal, dm_y, w(is_diel, dd_y, dny)))
    nd_z = w(is_lam, dl_z, w(is_metal, dm_z, w(is_diel, dd_z, dnz)))

    # ---- terminal contributions into the lane accumulator ----------------
    sky_tv = 0.5 * (udy + 1.0)
    skyx = 1.0 - sky_tv + sky_tv * f32(0.5)
    skyy = 1.0 - sky_tv + sky_tv * f32(0.7)
    skyz = 1.0 - sky_tv + sky_tv * f32(1.0)
    miss = live & (term == 1.0)
    stop_em = live & (term == 2.0)
    ewx, ewy, ewz = (tpx, tpy, tpz) if attenuate else (1.0, 1.0, 1.0)
    ax = ax + w(miss, tpx * skyx, 0.0)
    ay = ay + w(miss, tpy * skyy, 0.0)
    az = az + w(miss, tpz * skyz, 0.0)
    emit_now = stop_em & ~is_img
    ax = ax + w(emit_now, ewx * alb_x, 0.0)
    ay = ay + w(emit_now, ewy * alb_y, 0.0)
    az = az + w(emit_now, ewz * alb_z, 0.0)
    # image-texture emission waits for the step its texel is serviced
    emit_pend = stop_em & is_img
    pex = w(emit_pend, ewx, pex)
    pey = w(emit_pend, ewy, pey)
    pez = w(emit_pend, ewz, pez)

    # ---- advance the continuing path -------------------------------------
    flat = is_light | is_img
    tpx = w(cont, tpx * w(flat, 1.0, alb_x), tpx)
    tpy = w(cont, tpy * w(flat, 1.0, alb_y), tpy)
    tpz = w(cont, tpz * w(flat, 1.0, alb_z), tpz)
    ox, oy, oz = w(cont, px_, ox), w(cont, py_, oy), w(cont, pz_, oz)
    dx, dy, dz = w(cont, nd_x, dx), w(cont, nd_y, dy), w(cont, nd_z, dz)
    return (ox, oy, oz, dx, dy, dz, tm, tpx, tpy, tpz, pex, pey, pez,
            ax, ay, az, pix, b0p, b0r, b0g, b0b, b1p, b1r, b1g, b1b)


def _cam_to(cam: Camera, dev) -> Camera:
    """The camera's 0-d tensors on `dev` (differentiably)."""
    return Camera(*[Vec3(*(c.to(dev) for c in f)) if isinstance(f, Vec3)
                    else f.to(dev) for f in cam])


def replay_fb(scene: T.Scene, cam: Camera, rec: RecQ, pix_base: int, *,
              width: int, height: int, npx: int, attenuate: bool,
              t_min: float, seed: int, window: int,
              attr_rows: Optional[int] = None) -> torch.Tensor:
    """Differentiable reconstruction of the recorded forward's unnormalised
    radiance sums (npx, 3): replays every recorded step and deposits
    through the recorder's own window-banked slots.  Its vector-Jacobian
    product with the image cotangent is the render's backward.  Windows
    align with the recorder's (same `window`), so the two bank slots
    cannot overflow.  The path depth is pinned by the records."""
    check_attr_rows(scene, attr_rows)
    dev = rec.a.win.device
    tab, tri_tab, tri_ids, med_tab, med_ids = build_attr_table(
        scene, attr_rows)
    R = tab.shape[0]
    pad = lambda t: torch.cat([t, t.new_zeros((1, t.shape[1]))]).to(dev)
    tab, tri_tab, med_tab = pad(tab), pad(tri_tab), pad(med_tab)
    tri_row, med_row = _scan_map(tri_ids.to(dev)), _scan_map(med_ids.to(dev))
    cam = _cam_to(cam, dev)
    seed = int(seed) & MASK32
    pix_base_f = float(pix_base)
    drop = 3 * npx
    n_c = len(CARRY)

    idx3 = lambda bp: WQ._plane_idx(bp, npx, pix_base_f)

    def flush_slots(carry, fb):
        b0p, b0r, b0g, b0b, b1p, b1r, b1g, b1b = carry[17:25]
        fb = fb.index_add(0, torch.cat(idx3(b0p) + idx3(b1p)),
                          torch.cat([b0r, b0g, b0b, b1r, b1g, b1b]))
        neg = torch.full_like(b0p, -1.0)
        z = torch.zeros_like(b0r)
        return carry[:17] + (neg, z, z, z, neg, z, z, z), fb

    def flush_acc(carry, fb):
        ax, ay, az, ppix = carry[13:17]
        fb = fb.index_add(0, torch.cat(idx3(ppix)), torch.cat([ax, ay, az]))
        z = torch.zeros_like(ax)
        return carry[:13] + (z, z, z) + carry[16:], fb

    def window_fn(*args):
        carry, xw = args[:n_c], args[n_c:]
        for i in range(xw[0].shape[0]):
            carry = _replay_step(tab, tri_tab, med_tab, cam, width, height,
                                 seed, attenuate, t_min, carry,
                                 tuple(x[i] for x in xw))
        return carry

    def run_stage(carry, fb, res: ResQ, dn):
        xs = (res.pix, res.s, res.fresh,
              *_decode(res, R, tri_row, med_row), res.t, *dn, res.texel,
              res.fixk)
        for k0 in range(0, res.win.shape[0], window):
            xw = tuple(x[k0:k0 + window] for x in xs)
            carry = checkpoint(window_fn, *carry, *xw, use_reentrant=False,
                               preserve_rng_state=False)
            carry, fb = flush_slots(carry, fb)
        return carry, fb

    a, bres = rec.a, rec.b
    lanes_a, lanes_b = a.win.shape[1], bres.win.shape[1]

    # stage-A next-step directions: shifted within A; the last A step's
    # continuations survive into stage B, whose first recorded direction
    # maps back through the permutation
    pv, perm = rec.pvalid, rec.perm
    bidx = torch.where(pv, perm, lanes_a)
    back = lambda v: torch.zeros(lanes_a + 1, dtype=F32, device=dev).scatter(
        0, bidx, v)[:lanes_a]
    dn_a = [torch.cat([v[1:], back(vb[0])[None]])
            for v, vb in ((a.dx, bres.dx), (a.dy, bres.dy), (a.dz, bres.dz))]

    fb = torch.zeros(3 * npx + 1, dtype=F32, device=dev)
    carry_a, fb = run_stage(_zeros_carry(lanes_a, dev), fb, a, dn_a)
    # boundary: flush every lane's accumulator (the recorder's flush_acc),
    # then gather the surviving lanes' carries through the permutation
    carry_a, fb = flush_acc(carry_a, fb)
    dflt = _zeros_carry(lanes_b, dev)
    gth = lambda v, d: torch.where(pv, v[perm], d)
    carry_b = (tuple(gth(v, d) for v, d in zip(carry_a[:_N_PATH],
                                               dflt[:_N_PATH]))
               + dflt[_N_PATH:16] + (gth(carry_a[16], dflt[16]),)
               + dflt[17:])
    dn_b = [torch.cat([v[1:], v[-1:]]) for v in (bres.dx, bres.dy, bres.dz)]
    carry_b, fb = run_stage(carry_b, fb, bres, dn_b)
    _, fb = flush_acc(carry_b, fb)
    return fb[:drop].reshape(3, npx).transpose(0, 1)


# ---------------------------------------------------------------------------
# autograd.Function glue
# ---------------------------------------------------------------------------

class _RenderGrad(torch.autograd.Function):
    """Forward: the recording work queue.  Backward: the VJP of the replay
    w.r.t. the float leaves of (scene, camera), passed flat."""

    @staticmethod
    def forward(ctx, g, pix_base, samp_base, static, params, *flat):
        scene, cam = combine(with_leaves(params, list(flat)), static)
        fb, rec, ok = record_forward_q(scene, cam, g.width, g.height,
                                       pix_base, samp_base, **g.rcfg)
        g.last = (rec, ok)
        ctx.g, ctx.pix_base, ctx.static, ctx.params = (g, pix_base, static,
                                                       params)
        ctx.rec = rec
        ctx.save_for_backward(*flat)
        return fb * g.inv_spp

    @staticmethod
    def backward(ctx, gbar):
        g = ctx.g
        xs = [x.detach().requires_grad_(True) for x in ctx.saved_tensors]
        with torch.enable_grad():
            scene, cam = combine(with_leaves(ctx.params, xs), ctx.static)
            fb = replay_fb(scene, cam, ctx.rec, ctx.pix_base,
                           width=g.width, height=g.height,
                           **{k: g.rcfg[k] for k in (
                               "npx", "attenuate", "t_min",
                               "seed", "window")},
                           attr_rows=g.attr_rows)
            grads = torch.autograd.grad(fb, xs, gbar * g.inv_spp,
                                        allow_unused=True)
        ctx.rec = None
        return (None, None, None, None, None,
                *(torch.zeros_like(x) if d is None else d
                  for x, d in zip(xs, grads)))


class RenderGradFb:
    """`f(scene, cam, pix_base=0, samp_base=0) -> (npx, 3)` per-pixel mean
    radiance over samples [samp_base, samp_base+spp) of the pixel range
    [pix_base, pix_base+npx), differentiable w.r.t. every float leaf of
    scene and camera.  `cfg` holds the schedule; `last` the latest
    forward's (RecQ, ok)."""

    def __init__(self, width: int, height: int, rcfg: dict,
                 attr_rows: Optional[int]):
        self.width, self.height = width, height
        self.rcfg = rcfg
        self.attr_rows = attr_rows
        self.inv_spp = f32(1.0 / rcfg["spp"])
        self.cfg = dict(rcfg, width=width, height=height)
        self.last = None

    def __call__(self, scene: T.Scene, cam: Camera, pix_base: int = 0,
                 samp_base: int = 0) -> torch.Tensor:
        check_attr_rows(scene, self.attr_rows)
        params, static = partition((scene, cam))
        return _RenderGrad.apply(self, int(pix_base), int(samp_base), static,
                                 params, *leaves(params))


def render_grad_fb(width: int, height: int, npx: int, spp: int, *,
                   max_depth: int = 8, attenuate: bool = True,
                   t_min: float = T_MIN, seed: int = SEED,
                   rows: Optional[int] = None, rows_b: Optional[int] = None,
                   tile_rows: Optional[int] = None,
                   tile_rows_b: Optional[int] = None,
                   window: Optional[int] = None, chunk: Optional[int] = None,
                   max_steps: Optional[int] = None,
                   max_steps_b: Optional[int] = None,
                   avg_path_hint: float = AVG_PATH_HINT,
                   attr_rows: Optional[int] = None,
                   tail_pix: Optional[int] = None,
                   device: Union[str, torch.device] = "cuda") -> RenderGradFb:
    """Build the differentiable render `f` (see `RenderGradFb`): forward
    runs the recording work queue, backward the replay.  The keywords are
    the reference's; each schedule keyword given replaces the value
    derived below.

    The recording schedule is static: `max_steps` full-width steps on
    `rows` rows, sized from `avg_path_hint` mean segments a path, drain
    the sample queue, then the surviving long paths run `max_steps_b`
    (3*max_depth + 2 windows) steps on a grid of `rows_b` (rows/16) rows.
    If a scene's mean path exceeds the hint the queue does not drain and
    fb and gradients are partial; the recorder's `ok` flag (`f.last[1]`)
    says so: raise `avg_path_hint` or pass `max_steps`/`max_steps_b`."""
    dev = resolve_device(device)
    if tile_rows is None:
        tile_rows = WB.DEF_TILE_ROWS if dev.type == "cuda" else 8
    if chunk is None:
        chunk = WQ.pick_chunk(spp, cap=8)
    if window is None:
        window = max(4, min(16, 4 * chunk))
    L = npx * spp
    if rows is None:
        rows = min(128, max(tile_rows,
                            _round_up(-(-L // (LANE * 5)), tile_rows)))
    if tile_rows_b is None:
        tile_rows_b = min(8, tile_rows)
    if rows_b is None:
        rows_b = max(tile_rows_b, rows // 16)
    rows_b = _round_up(rows_b, tile_rows_b)
    lanes = rows * LANE
    if tail_pix is None:
        # singles cover about the last window's worth of grants; moot
        # when chunks are single-sample already
        tail_pix = 0 if chunk == 1 else min(npx // 2, lanes // 2)
    if max_steps is None:
        max_steps = (int(math.ceil(L * avg_path_hint / (lanes * 0.85)))
                     + 2 * window)
    if max_steps_b is None:
        max_steps_b = 3 * max_depth + 2 * window
    rcfg = dict(npx=npx, spp=spp, max_depth=max_depth, attenuate=attenuate,
                t_min=t_min, seed=seed, rows=rows, rows_b=rows_b,
                tile_rows=tile_rows, tile_rows_b=tile_rows_b, window=window,
                chunk=chunk, n_windows=-(-max_steps // window),
                n_windows_b=-(-max_steps_b // window), device=dev,
                tail_pix=int(tail_pix))
    return RenderGradFb(width, height, rcfg, attr_rows)
