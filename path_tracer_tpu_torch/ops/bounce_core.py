"""Plain PyTorch version of the bounce kernel: the executable spec.

`wave_step` is what `ops/csrc/wave_bounce.cu` computes, written with
tensor ops: the reference package's `ops/pallas/bounce_core.py:advance`
(one path segment: intersection folds in scan order, media, hit record,
textures, scatter, sky) plus the per-lane policy of its `_wave_kernel`
(fixup, stall, termination, depth exhaustion, next fixup, win record,
in-chunk regeneration, work count).  The wrapper `wave_bounce.wave_bounce`
calls it for CPU tensors; `chip_smoke.py` and the CUDA-only test hold the
kernel against it on the card.

Every float op is one rounded float32 op in the written order, as the
kernel (built with `-fmad=false`) does; sqrt is IEEE, sin/cos/log are
float64 rounded once (`core.vec`).  Where the reference works around the
TPU (a 2-carry fold with lane-gather reconstruction, a 16-way texture
sweep), this version keeps the semantics and drops the workaround: the
sphere fold takes the first minimum over blocks of spheres, the winner's
attributes and the special texture are direct indexed loads.

One deliberate difference from the reference: lanes that do not advance
(dead or stalled) report atlas index 0.  Their fixup kind is always NONE,
so the index is never read; the kernel skips their segment entirely.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..core.rng import (PI, INITIAL_STATE, MASK32, f32, next_f01, next_frange,
                        splitmix32)
from ..core.vec import fcos, fdiv, flog, fsin, fsqrt
from ..scene import types as T

LANE = 128
INF = float("inf")
BIG = 3.0e38

# meta packing: scan(10b) | texref(4b) | texkind(2b) | mtype(3b), exact in f32
M_TEXREF = 1024.0
M_TEXKIND = 1024.0 * 16.0
M_MTYPE = 1024.0 * 16.0 * 4.0
MAX_SPECIAL_TEX = 16

# fixup kinds carried between calls
FIX_NONE = 0.0
FIX_ALBEDO = 1.0   # throughput *= atlas[fix_idx]
FIX_EMIT = 2.0     # acc += fix_w * atlas[fix_idx]

_SPH_BLOCK = 128   # spheres per vectorised fold step
_TWO_PI = f32(2.0 * PI)
_PI = f32(PI)
_HALF_PI = f32(PI / 2)
_INV_2PI = f32(1.0 / (2.0 * PI))
_INV_PI = f32(1.0 / PI)
_INV255 = f32(1.0 / 255.0)


# ---------------------------------------------------------------------------
# helpers (bounce_core.py:61-131 of the reference).  Its _xs32, _u32_to_f01,
# _draw, _draw_range and _splitmix32 are core.rng's xs32_step, u32_to_f01,
# next_f01, next_frange and splitmix32: masked draws whose masked-off lanes
# keep their state.
# ---------------------------------------------------------------------------

def _fast_atan(t):
    """atan on [-1, 1], degree-17 odd minimax in Horner form."""
    t2 = t * t
    p = f32(-9.2563e-4)
    for c in (5.9624e-3, -1.97338e-2, 4.30889e-2, -7.5005e-2, 0.10571,
              -0.14182, 0.19993, -0.33332, 0.999999):
        p = p * t2 + f32(c)
    return p * t


def _fast_atan2(y, x):
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    t = lo / torch.where(hi == 0.0, 1.0, hi)
    a = _fast_atan(t)
    a = torch.where(ay > ax, _HALF_PI - a, a)
    a = torch.where(x < 0.0, _PI - a, a)
    return torch.where(y < 0.0, -a, a)


def _fast_asin(y):
    return _fast_atan2(y, fsqrt(torch.clamp_min(1.0 - y * y, 0.0)))


def _unpack_scan(meta):
    return meta - torch.floor(meta * (1.0 / M_TEXREF)) * M_TEXREF


# ---------------------------------------------------------------------------
# one path segment (bounce_core.py:153-659 of the reference)
# ---------------------------------------------------------------------------

class Adv(NamedTuple):
    """What one segment produces, before the policy."""
    rng: torch.Tensor
    hit: torch.Tensor
    miss: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    alb_x: torch.Tensor
    alb_y: torch.Tensor
    alb_z: torch.Tensor
    tk_image: torch.Tensor
    atlas_idx: torch.Tensor
    att_x: torch.Tensor
    att_y: torch.Tensor
    att_z: torch.Tensor
    did_scatter: torch.Tensor
    ndx: torch.Tensor
    ndy: torch.Tensor
    ndz: torch.Tensor
    stop_emit: torch.Tensor
    sky_x: torch.Tensor
    sky_y: torch.Tensor
    sky_z: torch.Tensor
    wscan: torch.Tensor
    wcls: torch.Tensor
    t_hit: torch.Tensor


def _sphere_fold(sph, lo, hi, moving, ox, oy, oz, dx, dy, dz, tm, a,
                 tmin_a, bk, bidx):
    """Running best (key, index) over spheres [lo, hi), key = t*|d|^2 from
    the direct c-o quadratic (sphere.hpp:59-106).  A later sphere must be
    strictly closer, so the result is the first minimum: each block takes
    its first minimum and replaces the carry only when strictly smaller."""
    col = lambda v: v.unsqueeze(-1)
    for c0 in range(lo, hi, _SPH_BLOCK):
        s = sph[:, c0:min(c0 + _SPH_BLOCK, hi)]
        if moving:
            kmov = (col(tm) - s[6]) * s[7]
            cox = (s[0] + kmov * s[3]) - col(ox)
            coy = (s[1] + kmov * s[4]) - col(oy)
            coz = (s[2] + kmov * s[5]) - col(oz)
        else:
            cox = s[0] - col(ox)
            coy = s[1] - col(oy)
            coz = s[2] - col(oz)
        nb = cox * col(dx) + coy * col(dy) + coz * col(dz)      # = -b
        cc = cox * cox + coy * coy + coz * coz - s[8]
        disc = nb * nb - col(a) * cc
        sq = fsqrt(disc)
        k1 = nb - sq
        k2 = nb + sq
        cand = torch.where(k1 > col(tmin_a), k1, k2)
        ok = (disc > 0.0) & (cand > col(tmin_a))   # tangent misses
        kmin, arg = torch.min(torch.where(ok, cand, INF), dim=-1)
        upd = kmin < bk
        bk = torch.where(upd, kmin, bk)
        bidx = torch.where(upd, (arg + c0).to(torch.float32), bidx)
    return bk, bidx


def sphere_fold(sph, sph_segs, ox, oy, oz, dx, dy, dz, tm, a, tmin_a):
    """The sphere fold over every media segment in table order: the best
    (key, index) of each lane, index 0 and key inf without a hit, and the
    running key after each segment but the last (the media clamp reads
    it).  `sph_segs` is the (M+1, 2) table as a list."""
    bk = torch.full_like(a, INF)
    bidx = torch.zeros_like(a)
    sph_snap = []
    start = 0
    for mseg, (static_end, end) in enumerate(sph_segs):
        bk, bidx = _sphere_fold(sph, start, static_end, False, ox, oy, oz,
                                dx, dy, dz, tm, a, tmin_a, bk, bidx)
        bk, bidx = _sphere_fold(sph, static_end, end, True, ox, oy, oz,
                                dx, dy, dz, tm, a, tmin_a, bk, bidx)
        if mseg < len(sph_segs) - 1:
            sph_snap.append(bk)
        start = end
    return bk, bidx, sph_snap


def advance(tables, ox, oy, oz, dx, dy, dz, tm, rng, alive,
            *, t_min: float) -> Adv:
    """One path segment for every lane; `alive` (bool) selects the lanes
    that trace.  Pure function of the values."""
    sph, rect, tri, med, spec = (tables.sph, tables.rect, tables.tri,
                                 tables.med, tables.spec)
    rect_segs = tables.rect_segs.tolist()
    tri_segs = tables.tri_segs.tolist()
    n_med = med.shape[1]
    where = torch.where
    tmin = f32(t_min)

    a = dx * dx + dy * dy + dz * dz
    a_safe = where(a == 0.0, 1.0, a)
    inv_a = 1.0 / a_safe
    tmin_a = tmin * a
    zero = torch.zeros_like(a)
    one = zero + 1.0

    # ---- sphere fold with per-media-segment snapshots ----------------------
    bk, bidx, sph_snap = sphere_fold(sph, tables.sph_segs.tolist(), ox, oy,
                                     oz, dx, dy, dz, tm, a, tmin_a)
    s_t = bk * inv_a

    # winner attributes: a direct indexed load (sphere 0 when nothing hit)
    w_attr = sph[:, bidx.long()]
    kmov_w = (tm - w_attr[6]) * w_attr[7]
    bcx = w_attr[0] + kmov_w * w_attr[3]
    bcy = w_attr[1] + kmov_w * w_attr[4]
    bcz = w_attr[2] + kmov_w * w_attr[5]
    brinv, bmeta, bpar = w_attr[9], w_attr[10], w_attr[11]
    bar, bag, bab = w_attr[12], w_attr[13], w_attr[14]

    # ---- rect fold (t space, reject form; rectangle.hpp:16-130) ------------
    inv_dx = 1.0 / dx
    inv_dy = 1.0 / dy
    inv_dz = 1.0 / dz
    rt = torch.full_like(a, INF)
    ru = rv = rmeta = rpar = rar = rag = rab = rxy = rxz = zero
    rect_snap = []
    start = 0
    for mseg in range(n_med + 1):
        for i in range(start, rect_segs[mseg]):
            r = rect[:, i].tolist()
            isxy, isxz, isyz, kk, a0, a1, b0, b1 = r[:8]
            o_k = isyz * ox + isxz * oy + isxy * oz
            d_k = isyz * dx + isxz * dy + isxy * dz
            t = (kk - o_k) / d_k          # a true divide; 0/0 rejects below
            ca = isxy + isxz
            o_a = ca * ox + isyz * oy
            d_a = ca * dx + isyz * dy
            cb = isxz + isyz
            o_b = isxy * oy + cb * oz
            d_b = isxy * dy + cb * dz
            av = o_a + t * d_a
            bv = o_b + t * d_b
            in_b = ~((av < a0) | (av > a1) | (bv < b0) | (bv > b1))
            ok = ~(t < tmin) & ~(t > rt) & in_b & (torch.abs(t) < BIG)
            rt = where(ok, t, rt)
            ru = where(ok, (av - a0) * r[8], ru)
            rv = where(ok, (bv - b0) * r[9], rv)
            rmeta = where(ok, r[10], rmeta)
            rpar = where(ok, r[11], rpar)
            rar = where(ok, r[12], rar)
            rag = where(ok, r[13], rag)
            rab = where(ok, r[14], rab)
            rxy = where(ok, isxy, rxy)
            rxz = where(ok, isxz, rxz)
        if mseg < n_med:
            rect_snap.append(rt)
        start = rect_segs[mseg]

    # ---- triangle fold (Moller-Trumbore, triangle.hpp:58-100) --------------
    tt = torch.full_like(a, INF)
    tmeta = tpar = tnx = tny = tnz = tar = tag = tab = zero
    tri_snap = []
    start = 0
    for mseg in range(n_med + 1):
        for i in range(start, tri_segs[mseg]):
            (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, nx, ny, nz, meta,
             par, cr, cg, cb_) = tri[:, i].tolist()
            hx = dy * e2z - dz * e2y
            hy = dz * e2x - dx * e2z
            hz = dx * e2y - dy * e2x
            aa = e1x * hx + e1y * hy + e1z * hz
            a_abs = torch.abs(aa)
            a_pos = aa > 0.0
            sx = ox - v0x
            sy = oy - v0y
            sz = oz - v0z
            u = sx * hx + sy * hy + sz * hz
            u_ok = ~((u > 0.0) ^ a_pos) & (torch.abs(u) <= a_abs)
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            v = dx * qx + dy * qy + dz * qz
            v_ok = ~((v > 0.0) ^ a_pos) & (torch.abs(u + v) <= a_abs)
            t = (e2x * qx + e2y * qy + e2z * qz) / aa
            ok = ((a_abs >= f32(1e-7)) & u_ok & v_ok & ~(t < tmin)
                  & ~(t > tt))
            tt = where(ok, t, tt)
            tmeta = where(ok, meta, tmeta)
            tpar = where(ok, par, tpar)
            tnx = where(ok, nx, tnx)
            tny = where(ok, ny, tny)
            tnz = where(ok, nz, tnz)
            tar = where(ok, cr, tar)
            tag = where(ok, cg, tag)
            tab = where(ok, cb_, tab)
        if mseg < n_med:
            tri_snap.append(tt)
        start = tri_segs[mseg]

    # ---- cross-class merge (render.hpp:37-49 scan-order tie rules) ---------
    psx = ox + s_t * dx
    psy = oy + s_t * dy
    psz = oz + s_t * dz
    w = dict(t=s_t, scan=_unpack_scan(bmeta), meta=bmeta, par=bpar, ar=bar,
             ag=bag, ab=bab, nx=(psx - bcx) * brinv, ny=(psy - bcy) * brinv,
             nz=(psz - bcz) * brinv, u=zero, v=zero, tie=zero, cls=zero)

    def merge(c):
        tie = c["t"] == w["t"]
        b_later = c["scan"] > w["scan"]
        tie_rule = ((b_later & (c["tie"] > 0.0))
                    | (~b_later & (w["tie"] <= 0.0)))
        b_wins = (c["t"] < w["t"]) | (tie & tie_rule)
        for k in w:
            w[k] = where(b_wins, c[k], w[k])

    merge(dict(t=rt, scan=_unpack_scan(rmeta), meta=rmeta, par=rpar, ar=rar,
               ag=rag, ab=rab, nx=1.0 - rxy - rxz, ny=rxz, nz=rxy, u=ru,
               v=rv, tie=one, cls=one))
    # triangle normal = cross(e1, e2), u = v = 0 (triangle.hpp:94-99)
    merge(dict(t=tt, scan=_unpack_scan(tmeta), meta=tmeta, par=tpar,
               ar=tar, ag=tag, ab=tab, nx=tnx, ny=tny, nz=tnz, u=zero,
               v=zero, tie=one, cls=one + 1.0))

    # ---- media (constant_medium.hpp:28-77) ---------------------------------
    earlier = torch.full_like(a, INF)
    ray_len = fsqrt(a)
    inv_len = ray_len * inv_a
    for m in range(n_med):
        (btype, mcx, mcy, mcz, mr, pmnx, pmny, pmnz, pmxx, pmxy, pmxz, nid,
         act, mmeta, mar, mag, mab) = med[:, m].tolist()
        ocx = ox - mcx
        ocy = oy - mcy
        ocz = oz - mcz
        b = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - f32(mr * mr)
        disc = b * b - a * cc
        has = disc > 0.0
        sq = fsqrt(where(has, disc, 0.0))
        st1 = (-b - sq) * inv_a
        st2 = (-b + sq) * inv_a
        hit2_s = has & (st2 > st1 + f32(1e-4))
        ts = []
        for (kk, o_k, id_k, o_a, d_a, a0, a1, o_b, d_b, b0, b1) in (
                (pmxz, oz, inv_dz, ox, dx, pmnx, pmxx, oy, dy, pmny, pmxy),
                (pmnz, oz, inv_dz, ox, dx, pmnx, pmxx, oy, dy, pmny, pmxy),
                (pmxy, oy, inv_dy, ox, dx, pmnx, pmxx, oz, dz, pmnz, pmxz),
                (pmny, oy, inv_dy, ox, dx, pmnx, pmxx, oz, dz, pmnz, pmxz),
                (pmxx, ox, inv_dx, oy, dy, pmny, pmxy, oz, dz, pmnz, pmxz),
                (pmnx, ox, inv_dx, oy, dy, pmny, pmxy, oz, dz, pmnz, pmxz)):
            t = (kk - o_k) * id_k
            av = o_a + t * d_a
            bv = o_b + t * d_b
            okb = (~((av < a0) | (av > a1) | (bv < b0) | (bv > b1))
                   & (torch.abs(t) < BIG))
            ts.append(where(okb, t, INF))
        entry = ts[0]
        for t_ in ts[1:]:
            entry = torch.minimum(entry, t_)
        exit_t = torch.full_like(a, INF)
        for t_ in ts:
            exit_t = torch.minimum(exit_t, where(t_ < entry + f32(1e-4),
                                                 INF, t_))
        hit2_b = (entry < BIG) & (exit_t < BIG)

        is_box = btype == 1.0
        hit2 = (hit2_b if is_box else hit2_s) & (act > 0.0)
        t_in = entry if is_box else st1
        t_out = exit_t if is_box else st2

        pre = torch.minimum(sph_snap[m] * inv_a, rect_snap[m])
        pre = torch.minimum(pre, tri_snap[m])
        pre = torch.minimum(pre, earlier)
        t1c = torch.clamp_min(torch.clamp_min(t_in, tmin), 0.0)
        t2c = torch.minimum(t_out, pre)
        draw_mask = alive & hit2 & ~(t1c >= t2c)
        rng, uni = next_f01(rng, draw_mask)
        uni = where(draw_mask, uni, 0.5)
        dist_inside = (t2c - t1c) * ray_len
        hit_distance = nid * flog(uni)
        accept = draw_mask & ~(hit_distance > dist_inside)
        t_e = t1c + hit_distance * inv_len
        merge(dict(t=where(accept, t_e, INF), scan=_unpack_scan(mmeta + zero),
                   meta=mmeta + zero, par=zero, ar=mar + zero, ag=mag + zero,
                   ab=mab + zero, nx=one, ny=zero, nz=zero, u=zero, v=zero,
                   tie=one, cls=one + 2.0))
        earlier = where(accept, torch.minimum(earlier, t_e), earlier)

    # ---- hit record (hitable.hpp:8-24) -------------------------------------
    hit = alive & (w["t"] < BIG)
    t_hit = where(hit, w["t"], 0.0)
    px = ox + t_hit * dx
    py = oy + t_hit * dy
    pz = oz + t_hit * dz
    front = (w["cls"] == 3.0) | ((dx * w["nx"] + dy * w["ny"]
                                  + dz * w["nz"]) < 0.0)
    nx_ = where(front, w["nx"], -w["nx"])
    ny_ = where(front, w["ny"], -w["ny"])
    nz_ = where(front, w["nz"], -w["nz"])
    # sphere uv: mercator of the flipped normal (sphere.hpp:13-24)
    phi = _fast_atan2(nz_, where((nx_ == 0.0) & (nz_ == 0.0), 1.0, nx_))
    theta = _fast_asin(torch.clamp(ny_, -1.0, 1.0))
    u_merc = 1.0 - (phi + _PI) * _INV_2PI
    v_merc = (theta + _HALF_PI) * _INV_PI
    is_sph_w = w["cls"] == 0.0
    uu = where(is_sph_w, u_merc, w["u"])
    vv = where(is_sph_w, v_merc, w["v"])

    w_meta = w["meta"]
    mtype = torch.floor(w_meta * (1.0 / M_MTYPE))
    rem = w_meta - mtype * M_MTYPE
    texkind = torch.floor(rem * (1.0 / M_TEXKIND))
    rem2 = rem - texkind * M_TEXKIND
    texref = torch.floor(rem2 * (1.0 / M_TEXREF))

    # ---- textures (texture.hpp): checker in place, image -> atlas index ----
    tex = spec[:, texref.long()]
    c1x, c1y, c1z, c2x, c2y, c2z, twf, thf, toff, tfreq = tex[1:11]
    tk_checker = texkind == 1.0
    tk_image = texkind == 2.0
    odd = (fsin(10.0 * px) * fsin(10.0 * py) * fsin(10.0 * pz)) < 0.0
    alb_x = where(tk_checker, where(odd, c1x, c2x), w["ar"])
    alb_y = where(tk_checker, where(odd, c1y, c2y), w["ag"])
    alb_z = where(tk_checker, where(odd, c1z, c2z), w["ab"])
    fu = torch.fmod(uu * tfreq, 1.0)
    fv = torch.fmod(vv * tfreq, 1.0)
    wm1 = torch.clamp_min(twf - 1.0, 0.0)
    hm1 = torch.clamp_min(thf - 1.0, 0.0)
    ti = torch.minimum(torch.clamp_min(torch.floor(fu * wm1), 0.0), wm1)
    tj = torch.minimum(torch.clamp_min(torch.floor((1.0 - fv) * hm1), 0.0),
                       hm1)
    atlas_idx = where(alive, toff + tj * twf + ti, 0.0)
    alb_x = where(tk_image, 1.0, alb_x)
    alb_y = where(tk_image, 1.0, alb_y)
    alb_z = where(tk_image, 1.0, alb_z)

    # ---- scatter (material.hpp:11-131), masked draws keep draw counts -----
    inv_len_d = 1.0 / fsqrt(a_safe)
    udx = dx * inv_len_d
    udy = dy * inv_len_d
    udz = dz * inv_len_d
    is_lam = hit & (mtype == T.MAT_LAMBERTIAN)
    is_metal = hit & (mtype == T.MAT_METAL)
    is_diel = hit & (mtype == T.MAT_DIELECTRIC)
    is_light = hit & (mtype == T.MAT_LIGHT)
    is_iso = hit & (mtype == T.MAT_ISOTROPIC)

    # lambertian: n + unit_vec (3 draws, rtweekend.hpp:60-67)
    rng, xl = next_frange(rng, -1.0, 1.0, is_lam)
    maxy = fsqrt(torch.clamp_min(1.0 - xl * xl, 0.0))
    rng, fy = next_f01(rng, is_lam)
    yl = -maxy + 2.0 * maxy * fy
    absz = fsqrt(torch.clamp_min(maxy * maxy - yl * yl, 0.0))
    rng, fz = next_f01(rng, is_lam)
    zl = where(fz > 0.5, absz, -absz)

    # metal: reflect + fuzz * ball (3 draws, rtweekend.hpp:70-80)
    rng, br = next_f01(rng, is_metal)
    rng, bth = next_frange(rng, 0.0, _TWO_PI, is_metal)
    rng, bph = next_frange(rng, 0.0, _PI, is_metal)
    plan = br * fsin(bph)
    ud_dot_n = udx * nx_ + udy * ny_ + udz * nz_
    rfl_x = udx - 2.0 * ud_dot_n * nx_
    rfl_y = udy - 2.0 * ud_dot_n * ny_
    rfl_z = udz - 2.0 * ud_dot_n * nz_
    par = w["par"]
    dm_x = rfl_x + par * (plan * fcos(bth))
    dm_y = rfl_y + par * (plan * fsin(bth))
    dm_z = rfl_z + par * (br * fcos(bph))
    metal_alive = (dm_x * nx_ + dm_y * ny_ + dm_z * nz_) > 0.0

    # dielectric (material.hpp:68-89): one draw only when refraction can be
    ior = where(is_diel, par, 1.5)
    ratio = where(front, 1.0 / ior, ior)
    cos_t = torch.clamp_max(-ud_dot_n, 1.0)
    sin_t = fsqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    omc = 1.0 - cos_t
    omc2 = omc * omc
    reflectance = r0 + (1.0 - r0) * (omc2 * omc2 * omc)
    diel_draw = is_diel & ~cannot
    rng, unid = next_f01(rng, diel_draw)
    choose_reflect = cannot | (diel_draw & (reflectance > unid))
    rp_x = (udx + cos_t * nx_) * ratio
    rp_y = (udy + cos_t * ny_) * ratio
    rp_z = (udz + cos_t * nz_) * ratio
    rpar = -fsqrt(torch.abs(1.0 - (rp_x * rp_x + rp_y * rp_y + rp_z * rp_z)))
    dd_x = where(choose_reflect, rfl_x, rp_x + rpar * nx_)
    dd_y = where(choose_reflect, rfl_y, rp_y + rpar * ny_)
    dd_z = where(choose_reflect, rfl_z, rp_z + rpar * nz_)

    # isotropic: ball (3 draws, material.hpp:122)
    rng, ir = next_f01(rng, is_iso)
    rng, ith = next_frange(rng, 0.0, _TWO_PI, is_iso)
    rng, iph = next_frange(rng, 0.0, _PI, is_iso)
    iplan = ir * fsin(iph)

    ndx = where(is_lam, nx_ + xl, where(is_metal, dm_x, where(
        is_diel, dd_x, iplan * fcos(ith))))
    ndy = where(is_lam, ny_ + yl, where(is_metal, dm_y, where(
        is_diel, dd_y, iplan * fsin(ith))))
    ndz = where(is_lam, nz_ + zl, where(is_metal, dm_z, where(
        is_diel, dd_z, ir * fcos(iph))))
    did_scatter = hit & ~is_light & (~is_metal | metal_alive)

    # ---- sky (render.hpp:83-87) --------------------------------------------
    sky_tv = 0.5 * (udy + 1.0)
    return Adv(rng=rng, hit=hit, miss=alive & ~hit, px=px, py=py, pz=pz,
               alb_x=alb_x, alb_y=alb_y, alb_z=alb_z, tk_image=tk_image,
               atlas_idx=atlas_idx,
               att_x=where(is_light, 1.0, alb_x),
               att_y=where(is_light, 1.0, alb_y),
               att_z=where(is_light, 1.0, alb_z),
               did_scatter=did_scatter, ndx=ndx, ndy=ndy, ndz=ndz,
               stop_emit=is_light & ~did_scatter,
               sky_x=1.0 - sky_tv + sky_tv * f32(0.5),
               sky_y=1.0 - sky_tv + sky_tv * f32(0.7),
               sky_z=1.0 - sky_tv + sky_tv * f32(1.0),
               wscan=w["scan"], wcls=w["cls"], t_hit=t_hit)


# ---------------------------------------------------------------------------
# camera ray regeneration (bounce_core.py:662-706 of the reference)
# ---------------------------------------------------------------------------

def camera_ray_block(cam: Sequence[float], pix, s_idx, seed0: int, mask,
                     cur_rng):
    """Seed the (pixel, sample) stream and make its camera ray for masked
    lanes (camera.hpp:93-100, jitter as render.hpp:96-97).  `cam` is the
    packed 23-float camera as Python floats, `pix`/`s_idx` float exact
    ints.  The associations are those of `integrator.camera_rays` +
    `Camera.get_ray`, bit for bit: the driver mixes the two per sample.
    Returns (rng, ox, oy, oz, dx, dy, dz, time)."""
    pix_u = pix.long() & MASK32
    s_u = torch.clamp_min(s_idx, 0.0).long() & MASK32
    st0 = splitmix32(pix_u ^ splitmix32(s_u ^ (int(seed0) & MASK32)))
    st0 = torch.where(st0 == 0, torch.full_like(st0, INITIAL_STATE), st0)
    rng = torch.where(mask, st0, cur_rng)
    W, H = cam[21], cam[22]
    pyf = torch.floor((pix + 0.5) * f32(1.0 / W))
    pxf = pix - pyf * W
    rng, ju = next_f01(rng, mask)
    rng, jv = next_f01(rng, mask)
    su = fdiv(pxf + ju, W)
    sv = fdiv(pyf + jv, H)
    rng, dkx = next_frange(rng, -1.0, 1.0, mask)
    dmaxy = fsqrt(1.0 - dkx * dkx)
    rng, df = next_f01(rng, mask)
    dky = -dmaxy + (dmaxy - (-dmaxy)) * df
    rdx = dkx * cam[18]
    rdy = dky * cam[18]
    offx = cam[12] * rdx + cam[15] * rdy
    offy = cam[13] * rdx + cam[16] * rdy
    offz = cam[14] * rdx + cam[17] * rdy
    cdx = cam[3] + cam[6] * su + cam[9] * sv - cam[0] - offx
    cdy = cam[4] + cam[7] * su + cam[10] * sv - cam[1] - offy
    cdz = cam[5] + cam[8] * su + cam[11] * sv - cam[2] - offz
    rng, ctime = next_frange(rng, cam[19], cam[20], mask)
    return rng, cam[0] + offx, cam[1] + offy, cam[2] + offz, cdx, cdy, cdz, \
        ctime


# ---------------------------------------------------------------------------
# the kernel body with its policy (wave_bounce.py:275-439 of the reference)
# ---------------------------------------------------------------------------

def wave_step(tables, st, fix, texel, srv, *, t_min: float, max_depth: int,
              attenuate: bool):
    """One bounce for every lane: the plain version of the CUDA kernel.
    `st` holds the 24 state planes (WaveState order), `fix` the 5 pending
    fixup planes, `texel` the int32 atlas texels (R | G<<8 | B<<16) the
    texel service resolved and `srv` the 0/1 mask of fixups it covered.
    Returns the 28 output planes in the kernel's order: the 21 read-write
    state planes, the 5 fixup planes, win and t_hit."""
    where = torch.where
    (ox, oy, oz, dx, dy, dz, tm, rng, tpx, tpy, tpz, radx, rady, radz,
     accx, accy, accz, alive, s, bnc, wrk, pix, send, strd) = st
    fk_in, fidx_in, fwx_in, fwy_in, fwz_in = fix
    alive_b = alive > 0.0

    # ---- apply the deferred fixup (texture.hpp:144-150, scale 1/255) ------
    txr = (texel & 0xFF).to(torch.float32) * _INV255
    txg = ((texel >> 8) & 0xFF).to(torch.float32) * _INV255
    txb = ((texel >> 16) & 0xFF).to(torch.float32) * _INV255
    pend = fk_in != FIX_NONE
    srvb = pend & (srv > 0.0)
    stall = pend & ~srvb
    is_alb_fix = srvb & (fk_in == FIX_ALBEDO)
    is_emit_fix = srvb & (fk_in == FIX_EMIT)
    tpx = where(is_alb_fix, tpx * txr, tpx)
    tpy = where(is_alb_fix, tpy * txg, tpy)
    tpz = where(is_alb_fix, tpz * txb, tpz)
    acc_x0 = accx + where(is_emit_fix, fwx_in * txr, 0.0)
    acc_y0 = accy + where(is_emit_fix, fwy_in * txg, 0.0)
    acc_z0 = accz + where(is_emit_fix, fwz_in * txb, 0.0)

    # ---- one segment; stalled lanes do not advance -------------------------
    alive_adv = alive_b & ~stall
    adv = advance(tables, ox, oy, oz, dx, dy, dz, tm, rng, alive_adv,
                  t_min=t_min)

    # ---- termination and sky (render.hpp:58-91) ----------------------------
    rxv = radx + where(adv.miss, tpx * adv.sky_x, 0.0)
    ryv = rady + where(adv.miss, tpy * adv.sky_y, 0.0)
    rzv = radz + where(adv.miss, tpz * adv.sky_z, 0.0)
    # emission on scatter-fail is unattenuated in the reference
    # (render.hpp:73); attenuate=True gives the physical alternative
    if attenuate:
        ew_x, ew_y, ew_z = tpx, tpy, tpz
    else:
        ew_x = ew_y = ew_z = torch.ones_like(tpx)
    emit_inline = adv.stop_emit & ~adv.tk_image
    rxv = rxv + where(emit_inline, ew_x * adv.alb_x, 0.0)
    ryv = ryv + where(emit_inline, ew_y * adv.alb_y, 0.0)
    rzv = rzv + where(emit_inline, ew_z * adv.alb_z, 0.0)

    cont = adv.did_scatter
    tpx_n = where(cont, tpx * adv.att_x, tpx)
    tpy_n = where(cont, tpy * adv.att_y, tpy)
    tpz_n = where(cont, tpz * adv.att_z, tpz)

    # ---- depth exhaustion --------------------------------------------------
    bnc_n = where(alive_adv, bnc + 1.0, bnc)
    exhausted = cont & (bnc_n >= float(max_depth))
    alive_n = cont & ~exhausted
    finished = alive_adv & ~alive_n
    acx_n = acc_x0 + where(finished, rxv, 0.0)
    acy_n = acc_y0 + where(finished, ryv, 0.0)
    acz_n = acc_z0 + where(finished, rzv, 0.0)

    # ---- next fixup: ALBEDO only for a path that goes on (an exhausted path
    # returns black, render.hpp:91) ------------------------------------------
    fk = where(alive_n & adv.tk_image, FIX_ALBEDO,
               where(adv.stop_emit & adv.tk_image, FIX_EMIT, FIX_NONE))
    o_fix = (where(stall, fk_in, fk), where(stall, fidx_in, adv.atlas_idx),
             where(stall, fwx_in, ew_x), where(stall, fwy_in, ew_y),
             where(stall, fwz_in, ew_z))

    # ---- win record ((term*4 + cls)*1024 + scan) + 1, 0 = did not advance.
    # term: 0 continue, 1 sky, 2 emission stop, 3 absorb, 4 exhausted ------
    term = where(adv.miss, 1.0, where(adv.stop_emit, 2.0, where(
        adv.hit & ~(adv.did_scatter | adv.stop_emit), 3.0,
        where(exhausted, 4.0, 0.0))))
    win = where(alive_adv, (term * 4.0 + adv.wcls) * 1024.0 + adv.wscan + 1.0,
                0.0)

    # ---- in-chunk regeneration (next sample of this pixel) -----------------
    s_next = s + strd
    regen = (finished | ~alive_b) & (s_next < send) & ~stall
    s_n = where(regen, s_next, s)
    (rng_n, cox, coy, coz, cdx, cdy, cdz, ctime) = camera_ray_block(
        tables.cam.tolist(), pix, s_n, tables.seed, regen, adv.rng)
    zero_rad = regen | finished
    out = (where(regen, cox, where(cont, adv.px, ox)),
           where(regen, coy, where(cont, adv.py, oy)),
           where(regen, coz, where(cont, adv.pz, oz)),
           where(regen, cdx, where(cont, adv.ndx, dx)),
           where(regen, cdy, where(cont, adv.ndy, dy)),
           where(regen, cdz, where(cont, adv.ndz, dz)),
           where(regen, ctime, tm),
           rng_n,
           where(regen, 1.0, tpx_n), where(regen, 1.0, tpy_n),
           where(regen, 1.0, tpz_n),
           where(zero_rad, 0.0, rxv), where(zero_rad, 0.0, ryv),
           where(zero_rad, 0.0, rzv),
           acx_n, acy_n, acz_n,
           where(alive_n | regen | (stall & alive_b), 1.0, 0.0),
           s_n,
           where(regen, 0.0, bnc_n),
           wrk + where(alive_adv, 1.0, 0.0))
    return out + o_fix + (win, adv.t_hit)
