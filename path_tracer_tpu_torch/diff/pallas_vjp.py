"""Pixel-pinned gradients by record and replay, and the gradient entry
point `make_render_grad`.

Mirrors the reference package's `diff/pallas_vjp.py` (its "r4" route).
In the port the forward runs the bounce kernel K1
(`ops.wave_bounce.wave_bounce`: the CUDA kernel on CUDA tensors, its plain
version on CPU tensors):

* **Forward** (`record_forward`): one sample is pinned to each lane for
  `max_depth` bounces; each bounce is one K1 call with no pending fixups,
  whose image-texture fixups the driver resolves at once
  (`engine.wq.resolve_fixups`).  Every bounce records the incoming
  direction, the winner record `win` ((term*4 + cls)*1024 + scan, + 1),
  the winner t and the texel (`Residuals`).
* **Backward** (`replay_radiance`): a winner-only replay rebuilds every
  differentiable quantity of the path from the records, gathering only
  the winning primitive's parameters each bounce, under torch autograd.
  Every discrete decision (winner, dielectric branch, medium acceptance,
  random unit vectors) is pinned to the recorded path: the detached-
  sampling estimator of `trace(differentiable=True)` and of the queued
  route (`diff.queued_vjp`), so all three agree up to float
  reassociation, except on a box: as in the reference, the replay finds
  a rect by its scan id, which a box's six sides share (`_scan_map`
  keeps the last), so a path on another side of a box replays against
  the wrong plane.  No RNG replay is needed: the Lambertian unit vector is
  d_next - n, the metal fuzz ball (d_next - reflect)/fuzz, the medium's
  log u comes from the recorded event t, and the first ray comes again,
  differentiably, from `camera_rays` with the recorded stream seed.

`render_grad_fn` joins the two in a `torch.autograd.Function` for any
(pixel, sample) list; `make_render_grad` is the production entry point:
on the canonical grid it takes the queued route by default and the
pinned route with `queued=False`.

Estimator cuts (as the reference's): medium event positions couple to
other geometry only through the detached interval clip; image texels are
detached (the atlas is uint8 data); silhouette terms are not estimated.

Reference semantics being differentiated: render.hpp:25-106,
material.hpp:11-131, sphere.hpp:59-106, rectangle.hpp:16-130,
triangle.hpp:58-100, constant_medium.hpp:28-77, camera.hpp:93-100.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.camera import Camera
from ..core.device import resolve_device
from ..core.rng import f32, seed_perf
from ..core.vec import frsqrt, fsin, fsqrt
from ..engine import wq as WQ
from ..engine.integrator import camera_rays
from ..ops import wave_bounce as WB
from ..scene import types as T
from .params import combine, leaves, partition, with_leaves
from .queued_vjp import _cam_to, render_grad_fb

LANE = WB.LANE
F32 = torch.float32
INV255 = f32(1.0 / 255.0)
N_SCAN = 1024      # scan ids the win record carries


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# Forward recording driver
# ---------------------------------------------------------------------------

class Residuals(NamedTuple):
    """Per-bounce records, all (depth, rows, 128) float32 except texel
    (int32)."""
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    win: torch.Tensor      # ((term*4 + cls)*1024 + scan) + 1; 0 = dead
    t: torch.Tensor        # winner t
    texel: torch.Tensor    # R | G<<8 | B<<16 (valid where a fixup fired)


def _padded_ids(pix: torch.Tensor, samp: torch.Tensor, lanes: int, dev):
    """pix and samp (exact small ints, any dtype) as int64 on `dev`,
    zero-padded to `lanes`."""
    out = []
    for ids in (pix, samp):
        v = torch.zeros(lanes, dtype=torch.long, device=dev)
        v[:ids.shape[0]] = ids.to(dev).long()
        out.append(v)
    return out


def record_forward(scene: T.Scene, cam: Camera, width: int, height: int,
                   pix: torch.Tensor, samp: torch.Tensor, *, max_depth: int,
                   attenuate: bool, t_min: float, seed: int, tile_rows: int,
                   device: Union[str, torch.device]
                   ) -> Tuple[torch.Tensor, Residuals]:
    """Trace one sample per lane through K1 for `max_depth` bounces,
    recording residuals.  `pix`/`samp` are (L,) ids; L pads up to a
    multiple of tile_rows*128 lanes.  No host read inside the loop.
    Returns (radiance (L, 3), residuals)."""
    dev = resolve_device(device)
    L = pix.shape[0]
    lanes = _round_up(L, tile_rows * LANE)
    rows = lanes // LANE
    sh = (rows, LANE)
    tables, atlas_flat, n_atlas = WQ.k1_inputs(scene, cam, width, height,
                                               seed, dev)

    pix_f, samp_f = _padded_ids(pix, samp, lanes, dev)
    rng1, o, d, tmv = camera_rays(cam, width, height, pix_f,
                                  seed_perf(pix_f, samp_f, seed))
    z = torch.zeros(sh, dtype=F32, device=dev)
    one = torch.ones(sh, dtype=F32, device=dev)
    samp_p = samp_f.to(F32).reshape(sh)
    st = WB.WaveState(
        ox=o.x.reshape(sh), oy=o.y.reshape(sh), oz=o.z.reshape(sh),
        dx=d.x.reshape(sh), dy=d.y.reshape(sh), dz=d.z.reshape(sh),
        tm=tmv.reshape(sh), rng=rng1.reshape(sh), tpx=one, tpy=one, tpz=one,
        radx=z, rady=z, radz=z, accx=z, accy=z, accz=z,
        alive=(torch.arange(lanes, device=dev) < L).to(F32).reshape(sh),
        s=samp_p, bnc=z, wrk=z, pix=pix_f.to(F32).reshape(sh),
        send=samp_p, strd=one)                   # send = s: no regeneration

    recs = [torch.empty((max_depth, rows, LANE), dtype=torch.int32
                        if name == "texel" else F32, device=dev)
            for name in Residuals._fields]
    for k in range(max_depth):
        d_in = (st.dx, st.dy, st.dz)
        out = WB.wave_bounce(tables, st, t_min=t_min, max_depth=max_depth,
                             attenuate=attenuate, tile_rows=tile_rows)
        st, emit, texel = WQ.resolve_fixups(out.state, out.fix, atlas_flat,
                                            n_atlas)
        st = st._replace(accx=st.accx + emit[0], accy=st.accy + emit[1],
                         accz=st.accz + emit[2])
        for r, v in zip(recs, (*d_in, out.win, out.t_hit, texel)):
            r[k] = v
    rad = torch.stack([a.reshape(-1)[:L] for a in (st.accx, st.accy,
                                                     st.accz)], dim=-1)
    return rad, Residuals(*recs)


# ---------------------------------------------------------------------------
# Winner-only differentiable replay
# ---------------------------------------------------------------------------

def _scan_map(scan: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(1024,) scan id -> class-local row: the reference's
    `zeros.at[where(active, scan, 1023)].set(arange(n), mode="drop")`.
    Every inactive row writes id 1023, and torch's index_put_ leaves the
    order of duplicate writes undefined, so the table is built on the
    host: an id written more than once holds the last row that wrote it,
    as the reference's sequential scatter leaves it; ids outside
    [0, 1024) are dropped."""
    idx = np.where(active.detach().cpu().numpy(),
                   scan.detach().cpu().numpy().astype(np.int64), N_SCAN - 1)
    rows = np.arange(idx.shape[0])
    keep = (idx >= 0) & (idx < N_SCAN)
    idx, rows = idx[keep][::-1], rows[keep][::-1]
    ids, first = np.unique(idx, return_index=True)   # first from the end
    tab = np.zeros(N_SCAN, np.int64)
    tab[ids] = rows[first]
    return torch.from_numpy(tab).to(scan.device)


def _scan_maps(scene: T.Scene):
    """scan id -> class-local row, one int64 table a class (detached)."""
    return tuple(_scan_map(c.scan, c.active) for c in (
        scene.spheres, scene.rects, scene.triangles, scene.media))


def _gather(table: torch.Tensor, i: torch.Tensor):
    """The rows i (clamped into range: jnp.take mode="clip") of a
    (n, k) table, as k columns."""
    i = torch.clamp(i, 0, table.shape[0] - 1)
    return table.index_select(0, i).unbind(1)


def _class_tables(scene: T.Scene, dev):
    """Each class's float columns stacked into one (n, k) table and its
    int columns into another, on `dev` (differentiably)."""
    sph, rect, tri, med = (scene.spheres, scene.rects, scene.triangles,
                           scene.media)
    mats, texs = scene.materials, scene.textures
    st = lambda cols: torch.stack([c.to(dev, F32) for c in cols], dim=1)
    si = lambda cols: torch.stack([c.to(dev).long() for c in cols], dim=1)
    return dict(
        sph=st([*sph.c0, *sph.c1, sph.time0, sph.time1, sph.radius]),
        sph_i=si([sph.mat]),
        rect=st([rect.k]), rect_i=si([rect.axis, rect.mat]),
        tri=st([*tri.v0, *tri.v1, *tri.v2]), tri_i=si([tri.mat]),
        med=st([*med.c, med.r, *med.pmin, *med.pmax, med.neg_inv_density]),
        med_i=si([med.btype, med.mat]),
        mat=st([mats.param, *mats.color]), mat_i=si([mats.mtype, mats.tex]),
        tex=st([*texs.c1, *texs.c2]), tex_i=si([texs.ttype]))


def _seg(tb, maps, attenuate: bool, t_min: float, tmv, carry, rec):
    """One recorded bounce for every lane, winner-only, differentiable in
    the class tables `tb` (the reference's `seg`, op for op)."""
    ox, oy, oz, dx, dy, dz, tpx, tpy, tpz, radx, rady, radz, alive = carry
    win, t_rec, dnx, dny, dnz, texel = rec
    s2sph, s2rect, s2tri, s2med = maps
    w = torch.where

    enc = torch.clamp(win - 1.0, min=0.0)     # win = encoded + 1; 0 = dead
    term = torch.floor(enc * f32(1.0 / 4096.0))
    rem = enc - term * 4096.0
    cls = torch.floor(rem * f32(1.0 / 1024.0))
    scan = (rem - cls * 1024.0).long()
    hit = alive & (term != 1.0)               # term 1 = sky miss
    cont = alive & (term == 0.0)

    a = dx * dx + dy * dy + dz * dz
    a_safe = w(a == 0.0, 1.0, a)
    inv_len = frsqrt(a_safe)    # rsqrt, rounded alike on every device
    udx, udy, udz = dx * inv_len, dy * inv_len, dz * inv_len

    # ---- winner t + normal per class (gather only the winner) ------------
    sc = torch.clamp(scan, 0, N_SCAN - 1)
    i_s, i_r, i_t, i_m = (m[sc] for m in (s2sph, s2rect, s2tri, s2med))

    # sphere, moving centre at tm (sphere.hpp:26-117)
    c0x, c0y, c0z, c1x, c1y, c1z, st0, st1, srad = _gather(tb["sph"], i_s)
    dt_ = st1 - st0
    frac = w(dt_ == 0.0, 0.0, (tmv - st0) / w(dt_ == 0.0, 1.0, dt_))
    cx = c0x + frac * (c1x - c0x)
    cy = c0y + frac * (c1y - c0y)
    cz = c0z + frac * (c1z - c0z)
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - srad * srad
    disc = b * b - a_safe * cc
    # sqrt(0) has an infinite derivative; masked lanes (clipped gathers,
    # other classes' winners) would turn it into NaN cotangents
    pos = (disc > 0.0).detach()
    sq = fsqrt(w(pos, disc, 1.0)) * pos.to(F32)
    k1 = (-b - sq) / a_safe
    k2 = (-b + sq) / a_safe
    pick1 = ((k1 - t_rec).abs() <= (k2 - t_rec).abs()).detach()
    t_sph = w(pick1, k1, k2)

    # rect: t = (k - o_ax) / d_ax (rectangle.hpp)
    (rk,) = _gather(tb["rect"], i_r)
    rax, rmat = _gather(tb["rect_i"], i_r)
    is_xy = rax == T.RECT_XY
    is_xz = rax == T.RECT_XZ
    o_ax = w(is_xy, oz, w(is_xz, oy, ox))
    d_ax = w(is_xy, dz, w(is_xz, dy, dx))
    d_ax = w(d_ax == 0.0, 1.0, d_ax)
    t_rect = (rk - o_ax) / d_ax

    # triangle (Moller-Trumbore)
    v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z = _gather(tb["tri"], i_t)
    e1x, e1y, e1z = v1x - v0x, v1y - v0y, v1z - v0z
    e2x, e2y, e2z = v2x - v0x, v2y - v0y, v2z - v0z
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
    (mcx, mcy, mcz, mr, pmnx, pmny, pmnz, pmxx, pmxy, pmxz,
     nid) = _gather(tb["med"], i_m)
    mb, mmat = _gather(tb["med_i"], i_m)
    mocx, mocy, mocz = ox - mcx, oy - mcy, oz - mcz
    mbq = mocx * dx + mocy * dy + mocz * dz
    mcc = mocx * mocx + mocy * mocy + mocz * mocz - mr * mr
    mdisc = mbq * mbq - a_safe * mcc
    mpos = (mdisc > 0.0).detach()
    msq = fsqrt(w(mpos, mdisc, 1.0)) * mpos.to(F32)
    ment_s = (-mbq - msq) / a_safe
    ent_b = torch.full_like(a, math.inf)
    for kk_, ov, dv, oav, dav, a0_, a1_, obv, dbv, b0_, b1_ in (
            (pmxz, oz, dz, ox, dx, pmnx, pmxx, oy, dy, pmny, pmxy),
            (pmnz, oz, dz, ox, dx, pmnx, pmxx, oy, dy, pmny, pmxy),
            (pmxy, oy, dy, ox, dx, pmnx, pmxx, oz, dz, pmnz, pmxz),
            (pmny, oy, dy, ox, dx, pmnx, pmxx, oz, dz, pmnz, pmxz),
            (pmxx, ox, dx, oy, dy, pmny, pmxy, oz, dz, pmnz, pmxz),
            (pmnx, ox, dx, oy, dy, pmny, pmxy, oz, dz, pmnz, pmxz)):
        dv_ = w(dv == 0.0, 1.0, dv)
        tt = (kk_ - ov) / dv_
        av = oav + tt * dav
        bv = obv + tt * dbv
        okb = ((av >= a0_) & (av <= a1_) & (bv >= b0_) & (bv <= b1_)
               & (dv != 0.0)).detach()
        ent_b = torch.minimum(ent_b, w(okb, tt, math.inf))
    ment = w(mb == T.MED_BOUND_BOX, ent_b, ment_s)
    t1c = torch.clamp(torch.clamp(ment, min=f32(t_min)), min=0.0)
    t1c = w(torch.isfinite(t1c), t1c, 0.0)
    ray_len = fsqrt(a_safe)
    nid_safe = w(nid == 0.0, -1.0, nid)
    logu = ((t_rec - t1c) * ray_len / nid_safe).detach()
    t_med = t1c + nid_safe * logu * inv_len

    is_s = cls == 0.0
    is_r = cls == 1.0
    is_t = cls == 2.0
    is_m = cls == 3.0
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
    n_rx = w(rax == T.RECT_YZ, 1.0, 0.0)
    n_ry = w(rax == T.RECT_XZ, 1.0, 0.0)
    n_rz = w(rax == T.RECT_XY, 1.0, 0.0)
    n_tx = e1y * e2z - e1z * e2y
    n_ty = e1z * e2x - e1x * e2z
    n_tz = e1x * e2y - e1y * e2x
    nx = w(is_s, n_sx, w(is_r, n_rx, w(is_t, n_tx, 1.0)))
    ny = w(is_s, n_sy, w(is_r, n_ry, w(is_t, n_ty, 0.0)))
    nz = w(is_s, n_sz, w(is_r, n_rz, w(is_t, n_tz, 0.0)))
    front = (is_m | ((dx * nx + dy * ny + dz * nz) < 0.0)).detach()
    fsign = w(front, 1.0, -1.0)
    nx, ny, nz = nx * fsign, ny * fsign, nz * fsign

    # ---- winner material + albedo ----------------------------------------
    (smat,) = _gather(tb["sph_i"], i_s)
    (tmat,) = _gather(tb["tri_i"], i_t)
    mat_i = w(is_s, smat, w(is_r, rmat, w(is_t, tmat, mmat)))
    mpar, mcolx, mcoly, mcolz = _gather(tb["mat"], mat_i)
    mtype, tex_i = _gather(tb["mat_i"], mat_i)
    c1x_, c1y_, c1z_, c2x_, c2y_, c2z_ = _gather(tb["tex"], tex_i)
    (ttype,) = _gather(tb["tex_i"], tex_i)
    with torch.no_grad():
        odd = (fsin(10.0 * px_) * fsin(10.0 * py_) * fsin(10.0 * pz_)) < 0.0
    txr = (texel & 0xFF).to(F32) * INV255
    txg = ((texel >> 8) & 0xFF).to(F32) * INV255
    txb = ((texel >> 16) & 0xFF).to(F32) * INV255
    is_plain = (mtype == T.MAT_METAL) | (mtype == T.MAT_DIELECTRIC)
    is_chk = ttype == T.TEX_CHECKER
    is_img = ttype == T.TEX_IMAGE
    alb_x = w(is_chk, w(odd, c1x_, c2x_), w(is_img, txr, c1x_))
    alb_y = w(is_chk, w(odd, c1y_, c2y_), w(is_img, txg, c1y_))
    alb_z = w(is_chk, w(odd, c1z_, c2z_), w(is_img, txb, c1z_))
    alb_x = w(is_plain, mcolx, alb_x)
    alb_y = w(is_plain, mcoly, alb_y)
    alb_z = w(is_plain, mcolz, alb_z)

    # ---- scatter reconstruction (detached draws) -------------------------
    is_lam = mtype == T.MAT_LAMBERTIAN
    is_metal = mtype == T.MAT_METAL
    is_diel = mtype == T.MAT_DIELECTRIC
    is_light = mtype == T.MAT_LIGHT

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
    chose_reflect = ((dnx * nx + dny * ny + dnz * nz) > 0.0).detach()
    rp_x = (udx + cos_t * nx) * ratio
    rp_y = (udy + cos_t * ny) * ratio
    rp_z = (udz + cos_t * nz) * ratio
    rp_sq = rp_x * rp_x + rp_y * rp_y + rp_z * rp_z
    rps = (1.0 - rp_sq).abs()
    rpos = (rps > 0.0).detach()
    rpar_ = -fsqrt(w(rpos, rps, 1.0)) * rpos.to(F32)
    dd_x = w(chose_reflect, rfl_x, rp_x + rpar_ * nx)
    dd_y = w(chose_reflect, rfl_y, rp_y + rpar_ * ny)
    dd_z = w(chose_reflect, rfl_z, rp_z + rpar_ * nz)

    nd_x = w(is_lam, dl_x, w(is_metal, dm_x, w(is_diel, dd_x, dnx)))
    nd_y = w(is_lam, dl_y, w(is_metal, dm_y, w(is_diel, dd_y, dny)))
    nd_z = w(is_lam, dl_z, w(is_metal, dm_z, w(is_diel, dd_z, dnz)))

    # ---- radiance terms --------------------------------------------------
    sky_tv = 0.5 * (udy + 1.0)
    skyx = 1.0 - sky_tv + sky_tv * f32(0.5)
    skyy = 1.0 - sky_tv + sky_tv * f32(0.7)
    skyz = 1.0 - sky_tv + sky_tv * f32(1.0)
    miss = alive & (term == 1.0)
    stop_em = alive & (term == 2.0)
    radx = radx + w(miss, tpx * skyx, 0.0)
    rady = rady + w(miss, tpy * skyy, 0.0)
    radz = radz + w(miss, tpz * skyz, 0.0)
    ewx, ewy, ewz = (tpx, tpy, tpz) if attenuate else (1.0, 1.0, 1.0)
    radx = radx + w(stop_em, ewx * alb_x, 0.0)
    rady = rady + w(stop_em, ewy * alb_y, 0.0)
    radz = radz + w(stop_em, ewz * alb_z, 0.0)

    tpx = w(cont, tpx * w(is_light, 1.0, alb_x), tpx)
    tpy = w(cont, tpy * w(is_light, 1.0, alb_y), tpy)
    tpz = w(cont, tpz * w(is_light, 1.0, alb_z), tpz)
    return (w(cont, px_, ox), w(cont, py_, oy), w(cont, pz_, oz),
            w(cont, nd_x, dx), w(cont, nd_y, dy), w(cont, nd_z, dz),
            tpx, tpy, tpz, radx, rady, radz, cont)


def replay_radiance(scene: T.Scene, cam: Camera, res: Residuals,
                    pix: torch.Tensor, samp: torch.Tensor, *, width: int,
                    height: int, max_depth: int, attenuate: bool,
                    t_min: float, seed: int) -> torch.Tensor:
    """Differentiable winner-only replay of recorded paths -> (L, 3).
    Values match `record_forward`'s radiance up to reassociation; its
    vector-Jacobian product is the pinned route's gradient.  Each bounce
    is recomputed in the backward pass (`torch.utils.checkpoint`), so only
    the per-bounce carries are stored."""
    dev = res.dx.device
    L = pix.shape[0]
    lanes = res.dx.shape[1] * LANE
    cam = _cam_to(cam, dev)
    pix_f, samp_f = _padded_ids(pix, samp, lanes, dev)
    _, o0, d0, tm = camera_rays(cam, width, height, pix_f,
                                seed_perf(pix_f, samp_f, seed))
    tmv = tm.detach()      # camera time; its differentiable part is at k=0
    tb = _class_tables(scene, dev)
    maps = _scan_maps(scene)
    flat = lambda x: x.reshape(max_depth, lanes)
    win, t_rec, rdx, rdy, rdz, texel = (flat(x) for x in (
        res.win, res.t, res.dx, res.dy, res.dz, res.texel))

    def bounce(k, *carry):
        kn = (k + 1) % max_depth
        rec = (win[k], t_rec[k], rdx[kn], rdy[kn], rdz[kn], texel[k])
        return _seg(tb, maps, attenuate, t_min, tmv, carry, rec)

    one = torch.ones(lanes, dtype=F32, device=dev)
    zer = torch.zeros(lanes, dtype=F32, device=dev)
    carry = (o0.x, o0.y, o0.z, d0.x, d0.y, d0.z, one, one, one, zer, zer,
             zer, torch.arange(lanes, device=dev) < L)
    for k in range(max_depth):
        carry = checkpoint(bounce, k, *carry, use_reentrant=False,
                           preserve_rng_state=False)
    return torch.stack([c[:L] for c in carry[9:12]], dim=-1)


# ---------------------------------------------------------------------------
# autograd.Function glue
# ---------------------------------------------------------------------------

class _PinnedGrad(torch.autograd.Function):
    """Forward: `record_forward`.  Backward: the VJP of `replay_radiance`
    w.r.t. the float leaves of (scene, camera), passed flat; pix and samp
    get zero gradients."""

    @staticmethod
    def forward(ctx, g, static, params, pix, samp, *flat):
        scene, cam = combine(with_leaves(params, list(flat)), static)
        rad, res = record_forward(scene, cam, g.width, g.height, pix, samp,
                                  tile_rows=g.tile_rows, device=g.device,
                                  **g.cfg)
        g.last = res
        ctx.g, ctx.static, ctx.params, ctx.res = g, static, params, res
        ctx.save_for_backward(pix, samp, *flat)
        return rad

    @staticmethod
    def backward(ctx, gbar):
        g = ctx.g
        pix, samp, *flat = ctx.saved_tensors
        xs = [x.detach().requires_grad_(True) for x in flat]
        with torch.enable_grad():
            scene, cam = combine(with_leaves(ctx.params, xs), ctx.static)
            rad = replay_radiance(scene, cam, ctx.res, pix, samp,
                                  width=g.width, height=g.height, **g.cfg)
            grads = torch.autograd.grad(rad, xs, gbar, allow_unused=True)
        ctx.res = None
        return (None, None, None, torch.zeros_like(pix),
                torch.zeros_like(samp),
                *(torch.zeros_like(x) if d is None else d
                  for x, d in zip(xs, grads)))


class RenderGradFn:
    """`f(scene, cam, pix, samp) -> (L, 3)` per-sample radiance of the
    (pixel, sample) list, differentiable w.r.t. every float leaf of scene
    and camera; `pix`/`samp` are tensors of exact small ints (zero
    cotangent).  `last` holds the latest forward's residuals."""

    def __init__(self, width: int, height: int, cfg: dict, tile_rows: int,
                 device: torch.device):
        self.width, self.height = width, height
        self.cfg, self.tile_rows, self.device = cfg, tile_rows, device
        self.last = None

    def __call__(self, scene: T.Scene, cam: Camera, pix: torch.Tensor,
                 samp: torch.Tensor) -> torch.Tensor:
        params, static = partition((scene, cam))
        return _PinnedGrad.apply(self, static, params, pix, samp,
                                 *leaves(params))


def render_grad_fn(width: int, height: int, *, max_depth: int = 8,
                   attenuate: bool = True, t_min: float = 1e-3,
                   seed: int = 0, tile_rows: Optional[int] = None,
                   device: Union[str, torch.device] = "cuda") -> RenderGradFn:
    """Build `f(scene, cam, pix, samp) -> (L, 3)` (`RenderGradFn`) whose
    forward runs K1 on pixel-pinned lanes and whose backward runs the
    winner-only replay: the one route that differentiates an arbitrary
    (pixel, sample) list."""
    dev = resolve_device(device)
    if tile_rows is None:
        tile_rows = WB.DEF_TILE_ROWS if dev.type == "cuda" else 8
    cfg = dict(max_depth=max_depth, attenuate=attenuate, t_min=t_min,
               seed=seed)
    return RenderGradFn(width, height, cfg, tile_rows, dev)


def make_render_grad(width: int, height: int, pix, samp, *,
                     max_depth: int = 8, attenuate: bool = True,
                     t_min: float = 1e-3, seed: int = 0,
                     tile_rows: Optional[int] = None, queued: bool = True,
                     device: Union[str, torch.device] = "cuda",
                     **queued_kw):
    """Build `f(scene, cam) -> (npx, 3)`, the per-pixel mean radiance over
    the (pix, samp) sample grid: the production gradient entry point.

    `pix`/`samp` must form the canonical grid (pix = tile(pix0, spp) with
    contiguous pix0, samp = repeat(samp0 + arange(spp), npx)); the queued
    route (`diff.queued_vjp.render_grad_fb`, given `queued_kw`) needs that
    structure.  queued=False takes the pixel-pinned route
    (`render_grad_fn`, which `f.fn` holds): the same estimator, kept as a
    cross-check."""
    pix_np = np.asarray(torch.as_tensor(pix).cpu()).astype(np.int64)
    samp_np = np.asarray(torch.as_tensor(samp).cpu()).astype(np.int64)
    L = pix_np.shape[0]
    u = np.unique(samp_np)
    spp = len(u)
    npx = L // spp
    grid_ok = (
        npx * spp == L
        and np.array_equal(u, u[0] + np.arange(spp))
        and np.array_equal(samp_np, np.repeat(u, npx))
        and np.array_equal(pix_np, np.tile(pix_np[0] + np.arange(npx), spp)))
    if not grid_ok:
        raise ValueError(
            "make_render_grad needs the canonical (pix, samp) grid "
            "(tile(contiguous_pix, spp) / repeat(consecutive_samp, npx)); "
            "use render_grad_fn for arbitrary sample lists")
    if queued:
        fq = render_grad_fb(width, height, npx, spp, max_depth=max_depth,
                            attenuate=attenuate, t_min=t_min, seed=seed,
                            tile_rows=tile_rows, device=device, **queued_kw)
        pb, sb = int(pix_np[0]), int(u[0])
        return lambda scene, cam: fq(scene, cam, pb, sb)
    g = render_grad_fn(width, height, max_depth=max_depth,
                       attenuate=attenuate, t_min=t_min, seed=seed,
                       tile_rows=tile_rows, device=device)
    pix_f = torch.as_tensor(pix_np, dtype=F32)
    samp_f = torch.as_tensor(samp_np, dtype=F32)

    def f(scene: T.Scene, cam: Camera) -> torch.Tensor:
        rad = g(scene, cam, pix_f, samp_f)           # (L, 3) per sample
        return rad.reshape(spp, npx, 3).mean(0)
    f.fn = g
    return f
