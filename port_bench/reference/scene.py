"""The plain reference's scene: a configuration's builder calls read on
their own, into flat tables on a device.

Each call of a configuration's `CALLS` is read as the upstream defines it
(texture.hpp, material.hpp, sphere.hpp, rectangle.hpp, box.hpp,
triangle.hpp, constant_medium.hpp): a colour argument makes a solid
texture, a box is six rects in box.hpp's order, a medium makes its
isotropic phase material, and every hittable takes the next scan index
(its place in the scene vector, which decides ties and the medium's
clamp).  Nothing of the program is imported.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from .fmath import PI, f32, fsqrt, ftan

SOLID, CHECKER, IMAGE = 0, 1, 2
LAMBERTIAN, METAL, DIELECTRIC, LIGHT, ISOTROPIC = 0, 1, 2, 3, 4
XY, XZ, YZ = 0, 1, 2


class Tables(NamedTuple):
    sph: torch.Tensor        # (10, S): c0 xyz, dc xyz, t0, inv_dt, r^2, 1/r
    sph_mat: torch.Tensor    # (S,) int64 material
    sph_scan: torch.Tensor   # (S,) f32
    sph_segs: list           # per media segment: (static_end, end)
    rect: torch.Tensor       # (10, R): xy?, xz?, yz?, k, a0, a1, b0, b1, 1/da, 1/db
    rect_mat: torch.Tensor
    rect_scan: torch.Tensor
    rect_segs: list
    tri: torch.Tensor        # (12, T): v0, e1, e2, n = e1 x e2
    tri_mat: torch.Tensor
    tri_scan: torch.Tensor
    tri_segs: list
    med: List[tuple]         # per medium: (box?, c, r, pmin, pmax, -1/density)
    med_mat: List[int]
    med_scan: List[float]
    mtype: torch.Tensor      # per material, int64
    param: torch.Tensor      # fuzz / index of refraction
    rgb: torch.Tensor        # (3, M): colour of metal/dielectric, else the texture's c1
    color: torch.Tensor      # (3, M): the materials' own colour (metal, dielectric)
    texkind: torch.Tensor    # 0 none/solid, 1 checker, 2 image (int64)
    c2: torch.Tensor         # (3, M): the checker's even colour
    tex: torch.Tensor        # (4, M) f32: width, height, offset, freq
    atlas: torch.Tensor      # (N, 3) uint8 -> int64


def _inv(x: torch.Tensor) -> torch.Tensor:
    safe = torch.where(x == 0.0, 1.0, x)
    return torch.where(x == 0.0, 1.0, 1.0 / safe)


def read_calls(cfg) -> dict:
    """The configuration's calls as host lists (no tensors)."""
    tex, mats, atlas, n_atlas = [], [], [np.array([[0, 0, 1]], np.uint8)], 1
    sph, rect, tri, med = [], [], [], []
    scan = [0]

    def texture(a):
        if isinstance(a, dict):
            return a["ref"]
        tex.append((SOLID, tuple(a), (0, 0, 0), 1, 1, 0, 1.0))
        return len(tex) - 1

    def nxt():
        scan[0] += 1
        return scan[0] - 1

    for name, *a in cfg.CALLS:
        if name == "solid_texture":
            tex.append((SOLID, tuple(a[0]), (0, 0, 0), 1, 1, 0, 1.0))
        elif name == "checker_texture":
            tex.append((CHECKER, tuple(a[0]), tuple(a[1]), 1, 1, 0, 1.0))
        elif name == "image_texture":
            img = cfg.image(a[0])
            h, w = img.shape[:2]
            tex.append((IMAGE, (0, 0, 0), (0, 0, 0), w, h, n_atlas,
                        float(a[1]) if len(a) > 1 else 1.0))
            atlas.append(img.reshape(-1, 3))
            n_atlas += w * h
        elif name in ("lambertian", "light", "isotropic"):
            kind = {"lambertian": LAMBERTIAN, "light": LIGHT,
                    "isotropic": ISOTROPIC}[name]
            mats.append((kind, (0, 0, 0), 0.0, texture(a[0])))
        elif name == "metal":
            mats.append((METAL, tuple(a[0]), float(np.clip(a[1], 0, 1)), 0))
        elif name == "dielectric":
            mats.append((DIELECTRIC, tuple(a[1]), float(a[0]), 0))
        elif name == "add_sphere":
            sph.append((a[0], a[0], float(a[1]), 0.0, 0.0, a[2]["ref"], nxt()))
        elif name == "add_moving_sphere":
            sph.append((a[0], a[1], float(a[4]), float(a[2]), float(a[3]),
                        a[5]["ref"], nxt()))
        elif name in ("add_xy_rect", "add_xz_rect", "add_yz_rect"):
            axis = {"add_xy_rect": XY, "add_xz_rect": XZ,
                    "add_yz_rect": YZ}[name]
            rect.append((axis, *a[:5], a[5]["ref"], nxt(), 0))
        elif name == "add_box":
            (x0, y0, z0), (x1, y1, z1), m = a[0], a[1], a[2]["ref"]
            s = nxt()
            for sub, side in enumerate([(XY, x0, x1, y0, y1, z1),
                                        (XY, x0, x1, y0, y1, z0),
                                        (XZ, x0, x1, z0, z1, y1),
                                        (XZ, x0, x1, z0, z1, y0),
                                        (YZ, y0, y1, z0, z1, x1),
                                        (YZ, y0, y1, z0, z1, x0)]):
                rect.append(side + (m, s, sub))
        elif name == "add_triangle":
            tri.append((a[0], a[1], a[2], a[3]["ref"], nxt()))
        elif name == "add_constant_medium":
            bound, density, albedo = a
            mats.append((ISOTROPIC, (0, 0, 0), 0.0, texture(albedo)))
            m = len(mats) - 1
            if bound[0] == "sphere":
                med.append((False, bound[1], float(bound[2]), (0, 0, 0),
                            (0, 0, 0), -1.0 / float(density), m, nxt()))
            else:
                med.append((True, (0, 0, 0), 0.0, bound[1], bound[2],
                            -1.0 / float(density), m, nxt()))
        else:
            raise ValueError(f"unknown call {name!r}")
    return dict(tex=tex, mats=mats, atlas=np.concatenate(atlas), sph=sph,
                rect=rect, tri=tri, med=med)


def _pad8(n: int) -> int:
    return -(-max(n, 1) // 8) * 8


def build(cfg, device, dt=torch.float32) -> Tables:
    """Tables of the configuration's scene on `device` in dtype `dt`.
    Derived columns are computed in float32 on the CPU, then cast."""
    d = read_calls(cfg)
    f = torch.float32
    T = lambda rows: torch.tensor(np.asarray(rows, np.float32))
    med_scans = [m[7] for m in d["med"]]
    seg = lambda s: sum(s > m for m in med_scans)

    # spheres by (media segment, moving, scan)
    sph = sorted(d["sph"], key=lambda s: (seg(s[6]), s[3] != s[4], s[6]))
    if sph:
        c0, c1 = T([s[0] for s in sph]), T([s[1] for s in sph])
        rad, t0, t1 = (T([s[i] for s in sph]) for i in (2, 3, 4))
        inv_dt = torch.where(t1 - t0 == 0.0, 0.0, _inv(t1 - t0))
        dc = c1 - c0
        sph_t = torch.stack([c0[:, 0], c0[:, 1], c0[:, 2], dc[:, 0],
                             dc[:, 1], dc[:, 2], t0, inv_dt, rad * rad,
                             _inv(rad)])
    else:
        sph_t = torch.zeros((10, 0))
    n_m = len(med_scans)
    sph_segs = []
    for m in range(n_m + 1):
        st = sum(1 for s in sph if seg(s[6]) < m or
                 (seg(s[6]) == m and s[3] == s[4]))
        sph_segs.append((st, sum(1 for s in sph if seg(s[6]) <= m)))

    # rects by (segment, scan, side)
    rect = sorted(d["rect"], key=lambda r: (seg(r[7]), r[7], r[8]))
    ax = np.array([r[0] for r in rect])
    a0, a1, b0, b1, k = (T([r[i] for r in rect]) for i in (1, 2, 3, 4, 5))
    rect_t = torch.stack([torch.tensor(ax == XY, dtype=f),
                          torch.tensor(ax == XZ, dtype=f),
                          torch.tensor(ax == YZ, dtype=f), k, a0, a1, b0, b1,
                          _inv(a1 - a0), _inv(b1 - b0)]) if rect else \
        torch.zeros((10, 0))
    rect_segs = [sum(1 for r in rect if seg(r[7]) <= m)
                 for m in range(n_m + 1)]

    # triangles by (segment, scan)
    tri = sorted(d["tri"], key=lambda t: (seg(t[4]), t[4]))
    if tri:
        v0, v1, v2 = (T([t[i] for t in tri]) for i in (0, 1, 2))
        e1, e2 = v1 - v0, v2 - v0
        n = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                         e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                         e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], 1)
        tri_t = torch.cat([v0, e1, e2, n], 1).T
    else:
        tri_t = torch.zeros((12, 0))
    tri_segs = [sum(1 for t in tri if seg(t[4]) <= m) for m in range(n_m + 1)]

    # materials with their texture's columns
    tex, mats = d["tex"], d["mats"]
    mtype = [m[0] for m in mats]
    plain = [m[0] in (METAL, DIELECTRIC) for m in mats]
    rgb = [m[1] if p else tex[m[3]][1] for m, p in zip(mats, plain)]
    tk = [0 if p else {SOLID: 0, CHECKER: 1, IMAGE: 2}[tex[m[3]][0]]
          for m, p in zip(mats, plain)]
    c2 = [tex[m[3]][2] for m in mats]
    tcols = [(tex[m[3]][3], tex[m[3]][4], tex[m[3]][5], tex[m[3]][6])
             for m in mats]

    def dev(x, dtype=None):
        return x.to(device=device, dtype=dtype or dt).contiguous()

    lng = torch.int64
    return Tables(
        sph=dev(sph_t), sph_mat=dev(torch.tensor([s[5] for s in sph]), lng),
        sph_scan=dev(torch.tensor([float(s[6]) for s in sph]), f),
        sph_segs=sph_segs,
        rect=dev(rect_t), rect_mat=dev(torch.tensor([r[6] for r in rect],
                                                    dtype=lng), lng),
        rect_scan=dev(torch.tensor([float(r[7]) for r in rect]), f),
        rect_segs=rect_segs,
        tri=dev(tri_t), tri_mat=dev(torch.tensor([t[3] for t in tri],
                                                 dtype=lng), lng),
        tri_scan=dev(torch.tensor([float(t[4]) for t in tri]), f),
        tri_segs=tri_segs,
        med=[m[:6] for m in d["med"]], med_mat=[m[6] for m in d["med"]],
        med_scan=[float(m[7]) for m in d["med"]],
        mtype=dev(torch.tensor(mtype), lng),
        param=dev(T([m[2] for m in mats])),
        rgb=dev(T(rgb).T), color=dev(T([m[1] for m in mats]).T),
        texkind=dev(torch.tensor(tk), lng), c2=dev(T(c2).T),
        tex=dev(T(tcols).T, f),
        atlas=dev(torch.from_numpy(d["atlas"].astype(np.int64)), lng))


class Cam(NamedTuple):
    """The thin-lens camera (camera.hpp:67-100) as float32 values."""
    origin: tuple
    llc: tuple
    horizontal: tuple
    vertical: tuple
    u: tuple
    v: tuple
    lens_radius: float
    time0: float
    time1: float


def camera(c: dict, aspect: float) -> Cam:
    s = lambda x: torch.tensor(float(x), dtype=torch.float32)
    v3 = lambda p: [s(x) for x in p]
    lf, la, vup = v3(c["look_from"]), v3(c["look_at"]), v3(c["vup"])
    focus = c.get("focus")
    if focus is None:
        dd = (np.asarray(c["look_at"], np.float32)
              - np.asarray(c["look_from"], np.float32))
        focus = float(np.sqrt(np.sum(dd * dd)))
    theta = s(c["vfov"]) * s(PI) / s(180.0)
    vh = 2.0 * ftan(theta / 2.0)
    vw = s(aspect) * vh
    fd = s(focus)

    def unit(p):
        n = fsqrt(p[0] * p[0] + (p[1] * p[1] + p[2] * p[2]))
        return [x / n for x in p]

    def cross(a, b):
        return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0]]

    w = unit([a - b for a, b in zip(lf, la)])
    u = unit(cross(vup, w))
    v = cross(w, u)
    hor = [x * (fd * vw) for x in u]
    ver = [x * (fd * vh) for x in v]
    llc = [o - h * 0.5 - q * 0.5 - ww * fd
           for o, h, q, ww in zip(lf, hor, ver, w)]
    fl = lambda p: tuple(float(x) for x in p)
    return Cam(fl(lf), fl(llc), fl(hor), fl(ver), fl(u), fl(v),
               float(s(c["aperture"]) / 2.0), f32(c["time0"]),
               f32(c["time1"]))


def fold_rows(cfg) -> dict:
    """Rows of each intersection fold as the scene is packed for K1:
    static and moving spheres, rects, triangles (each class padded to a
    multiple of 8, the spheres' padding static) and media (at least 1)."""
    d = read_calls(cfg)
    moving = sum(1 for s in d["sph"] if s[3] != s[4])
    return dict(static=_pad8(len(d["sph"])) - moving, moving=moving,
                rect=_pad8(len(d["rect"])), tri=_pad8(len(d["tri"])),
                med=max(len(d["med"]), 1))
