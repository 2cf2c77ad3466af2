"""The plain reference: one path per (pixel, sample), traced to its end.

The upstream's semantics (render.hpp:37-99, camera.hpp:93-100,
sphere.hpp:59-106, rectangle.hpp, triangle.hpp:58-100,
constant_medium.hpp:28-77, material.hpp:11-131, texture.hpp:36-150),
written as flat tensor ops over a block of samples, with each sample's
xorshift stream seeded by (pixel, sample, frame seed) as the program
seeds it.  Float ops follow the upstream's association order and
`fmath`'s rounding, so a sample's radiance is the one the program's
kernel must give; image textures are read where they are hit.

`trace` gives each sample's radiance and segment count.  `dtype` selects
the working precision (the control runs in bfloat16); integers, scan
indices and random draws stay exact.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import scene as S
from .fmath import (PI, draw, draw_range, f32, fcos, fdiv, flog, fsin, fsqrt,
                    stream_seed)

INF = float("inf")
BIG = 3.0e38
_TWO_PI = f32(2.0 * PI)
_PI = f32(PI)
_HALF_PI = f32(PI / 2)
_INV_2PI = f32(1.0 / (2.0 * PI))
_INV_PI = f32(1.0 / PI)
_INV255 = f32(1.0 / 255.0)
SPH_BLOCK = 128


def _atan(t):
    t2 = t * t
    p = f32(-9.2563e-4)
    for c in (5.9624e-3, -1.97338e-2, 4.30889e-2, -7.5005e-2, 0.10571,
              -0.14182, 0.19993, -0.33332, 0.999999):
        p = p * t2 + f32(c)
    return p * t


def _atan2(y, x):
    ax, ay = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(ax, ay), torch.minimum(ax, ay)
    a = _atan(lo / torch.where(hi == 0.0, 1.0, hi))
    a = torch.where(ay > ax, _HALF_PI - a, a)
    a = torch.where(x < 0.0, _PI - a, a)
    return torch.where(y < 0.0, -a, a)


def _sphere_keys(tb, lo, hi, moving, ox, oy, oz, dx, dy, dz, tm, a, tmin_a,
                 bk, bidx):
    """First minimum of the key t*|d|^2 over spheres [lo, hi)."""
    col = lambda v: v.unsqueeze(-1)
    for c0 in range(lo, hi, SPH_BLOCK):
        s = tb.sph[:, c0:min(c0 + SPH_BLOCK, hi)]
        if moving:
            km = (col(tm) - s[6]) * s[7]
            cox = (s[0] + km * s[3]) - col(ox)
            coy = (s[1] + km * s[4]) - col(oy)
            coz = (s[2] + km * s[5]) - col(oz)
        else:
            cox, coy, coz = s[0] - col(ox), s[1] - col(oy), s[2] - col(oz)
        nb = cox * col(dx) + coy * col(dy) + coz * col(dz)
        cc = cox * cox + coy * coy + coz * coz - s[8]
        disc = nb * nb - col(a) * cc
        sq = fsqrt(disc)
        k1, k2 = nb - sq, nb + sq
        cand = torch.where(k1 > col(tmin_a), k1, k2)
        ok = (disc > 0.0) & (cand > col(tmin_a))
        kmin, arg = torch.min(torch.where(ok, cand, INF), dim=-1)
        upd = kmin < bk
        bk = torch.where(upd, kmin, bk)
        bidx = torch.where(upd, arg + c0, bidx)
    return bk, bidx


class Seg(NamedTuple):
    """One segment of every lane of a block."""
    rng: torch.Tensor
    hit: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    mat: torch.Tensor        # the winner's material (int64)
    alb: tuple               # albedo / emission, image texels applied
    cont: torch.Tensor       # the path scatters on
    emit: torch.Tensor       # the path stops on a light
    nd: tuple                # the scattered direction
    sky: tuple


def segment(tb: S.Tables, ox, oy, oz, dx, dy, dz, tm, rng, t_min: float
            ) -> Seg:
    """One path segment of every lane: closest hit in scan order,
    media, hit record, texture and scatter."""
    where = torch.where
    tmin = f32(t_min)
    a = dx * dx + dy * dy + dz * dz
    a_safe = where(a == 0.0, 1.0, a)
    inv_a = 1.0 / a_safe
    tmin_a = tmin * a
    zero = torch.zeros_like(a)
    one = zero + 1.0
    izero = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    fzero = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    n_med = len(tb.med)

    # spheres, with the running key after each media segment
    bk, bidx = torch.full_like(a, INF), izero
    snap_s, start = [], 0
    for m, (static_end, end) in enumerate(tb.sph_segs):
        bk, bidx = _sphere_keys(tb, start, static_end, False, ox, oy, oz, dx,
                                dy, dz, tm, a, tmin_a, bk, bidx)
        bk, bidx = _sphere_keys(tb, static_end, end, True, ox, oy, oz, dx,
                                dy, dz, tm, a, tmin_a, bk, bidx)
        if m < n_med:
            snap_s.append(bk)
        start = end
    s_t = bk * inv_a
    wa = tb.sph[:, bidx] if tb.sph.shape[1] else torch.zeros(
        (10,) + a.shape, dtype=a.dtype, device=a.device)
    km = (tm - wa[6]) * wa[7]
    bcx, bcy, bcz = (wa[0] + km * wa[3], wa[1] + km * wa[4],
                     wa[2] + km * wa[5])

    # rects, later equal t replaces
    inv_dx, inv_dy, inv_dz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    rt = torch.full_like(a, INF)
    ru = rv = rxy = rxz = zero
    rmat, rscan = izero, fzero
    snap_r, start = [], 0
    rect = tb.rect.cpu().tolist()
    for m in range(n_med + 1):
        for i in range(start, tb.rect_segs[m]):
            isxy, isxz, isyz, kk, a0, a1, b0, b1, ia, ib = (r[i] for r in rect)
            o_k = isyz * ox + isxz * oy + isxy * oz
            d_k = isyz * dx + isxz * dy + isxy * dz
            t = (kk - o_k) / d_k
            ca, cb = isxy + isxz, isxz + isyz
            av = (ca * ox + isyz * oy) + t * (ca * dx + isyz * dy)
            bv = (isxy * oy + cb * oz) + t * (isxy * dy + cb * dz)
            in_b = ~((av < a0) | (av > a1) | (bv < b0) | (bv > b1))
            ok = ~(t < tmin) & ~(t > rt) & in_b & (torch.abs(t) < BIG)
            rt = where(ok, t, rt)
            ru = where(ok, (av - a0) * ia, ru)
            rv = where(ok, (bv - b0) * ib, rv)
            rxy, rxz = where(ok, isxy, rxy), where(ok, isxz, rxz)
            rmat = where(ok, tb.rect_mat[i], rmat)
            rscan = where(ok, tb.rect_scan[i], rscan)
        if m < n_med:
            snap_r.append(rt)
        start = tb.rect_segs[m]

    # triangles (Moller-Trumbore)
    tt = torch.full_like(a, INF)
    tnx = tny = tnz = zero
    tmat, tscan = izero, fzero
    snap_t, start = [], 0
    tri = tb.tri.cpu().tolist()
    for m in range(n_med + 1):
        for i in range(start, tb.tri_segs[m]):
            (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, nx, ny,
             nz) = (r[i] for r in tri)
            hx = dy * e2z - dz * e2y
            hy = dz * e2x - dx * e2z
            hz = dx * e2y - dy * e2x
            aa = e1x * hx + e1y * hy + e1z * hz
            a_abs, a_pos = torch.abs(aa), aa > 0.0
            sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
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
            tnx, tny, tnz = (where(ok, nx, tnx), where(ok, ny, tny),
                             where(ok, nz, tnz))
            tmat = where(ok, tb.tri_mat[i], tmat)
            tscan = where(ok, tb.tri_scan[i], tscan)
        if m < n_med:
            snap_t.append(tt)
        start = tb.tri_segs[m]

    # merge across classes by the scene vector's tie rules
    psx, psy, psz = ox + s_t * dx, oy + s_t * dy, oz + s_t * dz
    rinv = wa[9]
    w = dict(t=s_t, scan=tb.sph_scan[bidx] if tb.sph.shape[1] else fzero,
             mat=tb.sph_mat[bidx] if tb.sph.shape[1] else izero,
             nx=(psx - bcx) * rinv, ny=(psy - bcy) * rinv,
             nz=(psz - bcz) * rinv, u=zero, v=zero, tie=fzero, cls=fzero)

    def merge(c):
        tie = c["t"] == w["t"]
        later = c["scan"] > w["scan"]
        rule = (later & (c["tie"] > 0.0)) | (~later & (w["tie"] <= 0.0))
        wins = (c["t"] < w["t"]) | (tie & rule)
        for k in w:
            w[k] = where(wins, c[k], w[k])

    merge(dict(t=rt, scan=rscan, mat=rmat, nx=1.0 - rxy - rxz, ny=rxz,
               nz=rxy, u=ru, v=rv, tie=fzero + 1.0, cls=fzero + 1.0))
    merge(dict(t=tt, scan=tscan, mat=tmat, nx=tnx, ny=tny, nz=tnz, u=zero,
               v=zero, tie=fzero + 1.0, cls=fzero + 2.0))

    # media: a free path inside the boundary, clamped by what came before
    earlier = torch.full_like(a, INF)
    ray_len = fsqrt(a)
    inv_len = ray_len * inv_a
    for m in range(n_med):
        is_box, c, r, pmn, pmx, nid = tb.med[m]
        mcx, mcy, mcz = (f32(x) for x in c)
        pmnx, pmny, pmnz = (f32(x) for x in pmn)
        pmxx, pmxy, pmxz = (f32(x) for x in pmx)
        mr, nid = f32(r), f32(nid)
        ocx, ocy, ocz = ox - mcx, oy - mcy, oz - mcz
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
            av, bv = o_a + t * d_a, o_b + t * d_b
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
        hit2 = ((entry < BIG) & (exit_t < BIG)) if is_box else hit2_s
        t_in, t_out = (entry, exit_t) if is_box else (st1, st2)
        pre = torch.minimum(snap_s[m] * inv_a, snap_r[m])
        pre = torch.minimum(torch.minimum(pre, snap_t[m]), earlier)
        t1c = torch.clamp_min(torch.clamp_min(t_in, tmin), 0.0)
        t2c = torch.minimum(t_out, pre)
        dm = hit2 & ~(t1c >= t2c)
        rng, uni = draw(rng, a.dtype, dm)
        uni = where(dm, uni, 0.5)
        hd = nid * flog(uni)
        accept = dm & ~(hd > (t2c - t1c) * ray_len)
        t_e = t1c + hd * inv_len
        merge(dict(t=where(accept, t_e, INF), scan=fzero + tb.med_scan[m],
                   mat=izero + tb.med_mat[m], nx=one, ny=zero, nz=zero,
                   u=zero, v=zero, tie=fzero + 1.0, cls=fzero + 3.0))
        earlier = where(accept, torch.minimum(earlier, t_e), earlier)

    # hit record
    hit = w["t"] < BIG
    t_hit = where(hit, w["t"], 0.0)
    px, py, pz = ox + t_hit * dx, oy + t_hit * dy, oz + t_hit * dz
    front = (w["cls"] == 3.0) | ((dx * w["nx"] + dy * w["ny"]
                                  + dz * w["nz"]) < 0.0)
    nx_ = where(front, w["nx"], -w["nx"])
    ny_ = where(front, w["ny"], -w["ny"])
    nz_ = where(front, w["nz"], -w["nz"])
    phi = _atan2(nz_, where((nx_ == 0.0) & (nz_ == 0.0), 1.0, nx_))
    yc = torch.clamp(ny_, -1.0, 1.0)
    theta = _atan2(yc, fsqrt(torch.clamp_min(1.0 - yc * yc, 0.0)))
    is_sph = w["cls"] == 0.0
    uu = where(is_sph, 1.0 - (phi + _PI) * _INV_2PI, w["u"])
    vv = where(is_sph, (theta + _HALF_PI) * _INV_PI, w["v"])

    # material and texture of the winner
    mat = w["mat"]
    mtype = tb.mtype[mat]
    tk = tb.texkind[mat]
    c1 = [tb.rgb[i][mat] for i in range(3)]
    c2 = [tb.c2[i][mat] for i in range(3)]
    twf, thf, toff, tfreq = (tb.tex[i][mat] for i in range(4))
    odd = (fsin(10.0 * px) * fsin(10.0 * py) * fsin(10.0 * pz)) < 0.0
    alb = [where(tk == 1, where(odd, a_, b_), a_) for a_, b_ in zip(c1, c2)]
    fu = torch.fmod(uu.float() * tfreq, 1.0)
    fv = torch.fmod(vv.float() * tfreq, 1.0)
    wm1 = torch.clamp_min(twf - 1.0, 0.0)
    hm1 = torch.clamp_min(thf - 1.0, 0.0)
    ti = torch.minimum(torch.clamp_min(torch.floor(fu * wm1), 0.0), wm1)
    tj = torch.minimum(torch.clamp_min(torch.floor((1.0 - fv) * hm1), 0.0),
                       hm1)
    aidx = (toff + tj * twf + ti).long()
    aidx = torch.clamp(aidx, 0, tb.atlas.shape[0] - 1)
    img = tk == 2
    alb = [where(img, (tb.atlas[aidx, i].to(torch.float32) * _INV255)
                 .to(a.dtype), x) for i, x in enumerate(alb)]

    # scatter, draws masked by material
    inv_len_d = 1.0 / fsqrt(a_safe)
    udx, udy, udz = dx * inv_len_d, dy * inv_len_d, dz * inv_len_d
    is_lam = hit & (mtype == S.LAMBERTIAN)
    is_metal = hit & (mtype == S.METAL)
    is_diel = hit & (mtype == S.DIELECTRIC)
    is_light = hit & (mtype == S.LIGHT)
    is_iso = hit & (mtype == S.ISOTROPIC)
    dt = a.dtype

    rng, xl = draw_range(rng, -1.0, 1.0, dt, is_lam)
    maxy = fsqrt(torch.clamp_min(1.0 - xl * xl, 0.0))
    rng, fy = draw(rng, dt, is_lam)
    yl = -maxy + 2.0 * maxy * fy
    absz = fsqrt(torch.clamp_min(maxy * maxy - yl * yl, 0.0))
    rng, fz = draw(rng, dt, is_lam)
    zl = where(fz > 0.5, absz, -absz)

    rng, br = draw(rng, dt, is_metal)
    rng, bth = draw_range(rng, 0.0, _TWO_PI, dt, is_metal)
    rng, bph = draw_range(rng, 0.0, _PI, dt, is_metal)
    plan = br * fsin(bph)
    udn = udx * nx_ + udy * ny_ + udz * nz_
    rfl = [udx - 2.0 * udn * nx_, udy - 2.0 * udn * ny_,
           udz - 2.0 * udn * nz_]
    par = tb.param[mat]
    dm_x = rfl[0] + par * (plan * fcos(bth))
    dm_y = rfl[1] + par * (plan * fsin(bth))
    dm_z = rfl[2] + par * (br * fcos(bph))
    metal_alive = (dm_x * nx_ + dm_y * ny_ + dm_z * nz_) > 0.0

    ior = where(is_diel, par, 1.5)
    ratio = where(front, 1.0 / ior, ior)
    cos_t = torch.clamp_max(-udn, 1.0)
    sin_t = fsqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    omc = 1.0 - cos_t
    omc2 = omc * omc
    refl = r0 + (1.0 - r0) * (omc2 * omc2 * omc)
    ddraw = is_diel & ~cannot
    rng, unid = draw(rng, dt, ddraw)
    choose = cannot | (ddraw & (refl > unid))
    rp = [(udx + cos_t * nx_) * ratio, (udy + cos_t * ny_) * ratio,
          (udz + cos_t * nz_) * ratio]
    rpar = -fsqrt(torch.abs(1.0 - (rp[0] * rp[0] + rp[1] * rp[1]
                                   + rp[2] * rp[2])))
    dd = [where(choose, f_, p_ + rpar * n_)
          for f_, p_, n_ in zip(rfl, rp, (nx_, ny_, nz_))]

    rng, ir = draw(rng, dt, is_iso)
    rng, ith = draw_range(rng, 0.0, _TWO_PI, dt, is_iso)
    rng, iph = draw_range(rng, 0.0, _PI, dt, is_iso)
    iplan = ir * fsin(iph)

    nd = (where(is_lam, nx_ + xl, where(is_metal, dm_x, where(
              is_diel, dd[0], iplan * fcos(ith)))),
          where(is_lam, ny_ + yl, where(is_metal, dm_y, where(
              is_diel, dd[1], iplan * fsin(ith)))),
          where(is_lam, nz_ + zl, where(is_metal, dm_z, where(
              is_diel, dd[2], ir * fcos(iph)))))
    cont = hit & ~is_light & (~is_metal | metal_alive)
    tv = 0.5 * (udy + 1.0)
    sky = (1.0 - tv + tv * f32(0.5), 1.0 - tv + tv * f32(0.7),
           1.0 - tv + tv * f32(1.0))
    return Seg(rng=rng, hit=hit, px=px, py=py, pz=pz, mat=mat, alb=alb,
               cont=cont, emit=is_light & ~cont, nd=nd, sky=sky)


def primary(cam: S.Cam, width: int, height: int, pix, sample, seed: int,
            dt):
    """Seed each (pixel, sample) stream and make its jittered camera ray
    (render.hpp:96-99, camera.hpp:93-100): 5 draws."""
    rng = stream_seed(pix, sample, seed)
    x = (pix % width).to(dt)
    y = torch.div(pix, width, rounding_mode="floor").to(dt)
    rng, ju = draw(rng, dt)
    rng, jv = draw(rng, dt)
    su, sv = fdiv(x + ju, float(width)), fdiv(y + jv, float(height))
    rng, dkx = draw_range(rng, -1.0, 1.0, dt)
    dmaxy = fsqrt(1.0 - dkx * dkx)
    rng, df = draw(rng, dt)
    dky = -dmaxy + (dmaxy - (-dmaxy)) * df
    lr = cam.lens_radius
    rdx, rdy = dkx * lr, dky * lr
    off = [cam.u[i] * rdx + cam.v[i] * rdy for i in range(3)]
    o = [cam.origin[i] + off[i] for i in range(3)]
    d = [cam.llc[i] + cam.horizontal[i] * su + cam.vertical[i] * sv
         - cam.origin[i] - off[i] for i in range(3)]
    rng, tm = draw_range(rng, cam.time0, cam.time1, dt)
    return rng, o, d, tm


def trace(tb: S.Tables, cam: S.Cam, width: int, height: int,
          pix: torch.Tensor, sample: torch.Tensor, seed, *,
          max_depth: int, t_min: float = 1e-3, block: int = 1 << 18):
    """Radiance (n, 3) and segments (n,) of each (pix, sample) path
    under frame seed `seed` (an int, or one a lane)."""
    n = pix.numel()
    dev, dt = pix.device, tb.sph.dtype
    rad = torch.zeros((n, 3), dtype=dt, device=dev)
    segs = torch.zeros(n, dtype=torch.int64, device=dev)
    for b0 in range(0, n, block):
        lanes = torch.arange(b0, min(b0 + block, n), device=dev)
        rng, o, d, tm = primary(cam, width, height, pix[lanes],
                                sample[lanes],
                                seed[lanes] if torch.is_tensor(seed)
                                else seed, dt)
        tp = [torch.ones(lanes.numel(), dtype=dt, device=dev)
              for _ in range(3)]
        for k in range(max_depth):
            if lanes.numel() == 0:
                break
            sg = segment(tb, *o, *d, tm, rng, t_min)
            segs[lanes] += 1
            miss = ~sg.hit
            # an emitter's light is returned unweighted by the path's
            # throughput: the upstream's quirk, which the program keeps
            val = [torch.where(miss, tp[i] * sg.sky[i],
                               torch.where(sg.emit, sg.alb[i], 0.0))
                   for i in range(3)]
            ends = ~sg.cont
            alive = sg.cont & (k + 1 < max_depth)
            rad[lanes] = torch.stack([torch.where(ends, 0.0 + v, 0.0)
                                      for v in val], 1)
            keep = alive
            lanes = lanes[keep]
            tp = [(tp[i] * sg.alb[i])[keep] for i in range(3)]
            o = [p[keep] for p in (sg.px, sg.py, sg.pz)]
            d = [x[keep] for x in sg.nd]
            tm, rng = tm[keep], sg.rng[keep]
    return rad, segs


def pixel_sums(rad: torch.Tensor, spp: int, chunk: int) -> torch.Tensor:
    """Per-pixel sums of (n_pix * spp, 3) radiance laid out pixel-major:
    each chunk of `chunk` samples summed in sample order, then the chunks
    in order (the order in which a renderer banks them)."""
    r = rad.reshape(-1, spp // chunk, chunk, 3)
    acc = torch.zeros_like(r[:, :, 0])
    for j in range(chunk):
        acc = acc + r[:, :, j]
    out = torch.zeros_like(acc[:, 0])
    for c in range(spp // chunk):
        out = out + acc[:, c]
    return out
