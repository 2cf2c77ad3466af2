"""Host-side scene construction (the reference's main.cpp:61-161 assembly).

Mirrors the reference package's `scene/builder.py` call for call: the
builder records primitives, materials and textures in host lists, packs
them with numpy in `build()`, and only then converts the arrays to
tensors on the requested device.  Scan indices record each hittable's
position in insertion order (render.hpp:37-49).
"""
from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.vec import Vec3
from . import types as T

Color = Tuple[float, float, float]


class TextureRef(int):
    """Opaque texture handle."""


class MaterialRef(int):
    """Opaque material handle."""


class SceneBuilder:
    def __init__(self):
        self._tex_rows: List[tuple] = []
        # the atlas starts with the reference's fallback texel (0,0,1)
        # (texture.hpp:157) at pixel offset 0
        self._atlas: List[np.ndarray] = [np.array([[0, 0, 1]], np.uint8)]
        self._atlas_pixels = 1
        self._mat_rows: List[tuple] = []
        self._spheres: List[tuple] = []
        self._rects: List[tuple] = []
        self._tris: List[tuple] = []
        self._media: List[tuple] = []
        self._n_hittables = 0

    # ---- textures ------------------------------------------------------
    def solid_texture(self, c: Color) -> TextureRef:
        self._tex_rows.append((T.TEX_SOLID, tuple(c), (0, 0, 0), 1, 1, 0, 1.0))
        return TextureRef(len(self._tex_rows) - 1)

    def checker_texture(self, odd: Color, even: Color) -> TextureRef:
        """checker_texture(c1, c2): odd=c1, even=c2 (texture.hpp:36-41)."""
        self._tex_rows.append(
            (T.TEX_CHECKER, tuple(odd), tuple(even), 1, 1, 0, 1.0))
        return TextureRef(len(self._tex_rows) - 1)

    def image_texture(self, source: Union[str, np.ndarray],
                      cyclic_frequency: float = 1.0) -> TextureRef:
        """An RGB8 image appended to the shared atlas (texture.hpp:97-117);
        `source` is a path or an (H, W, 3) uint8 array.  A file that cannot
        be read gives the reference's 1x1 fallback at offset 0
        (texture.hpp:106-111)."""
        data: Optional[np.ndarray] = None
        if isinstance(source, np.ndarray):
            data = np.ascontiguousarray(source, np.uint8).reshape(
                source.shape[0], source.shape[1], 3)
        else:
            try:
                from PIL import Image
                with Image.open(source) as im:
                    data = np.asarray(im.convert("RGB"), np.uint8)
            except (ImportError, OSError) as e:
                print(f"ERROR: Could not load texture image file "
                      f"'{source}'. {e}", file=sys.stderr)
        if data is None:
            w = h = 1
            offset = 0
        else:
            h, w = data.shape[:2]
            offset = self._atlas_pixels
            self._atlas.append(data.reshape(-1, 3))
            self._atlas_pixels += w * h
        self._tex_rows.append((T.TEX_IMAGE, (0, 0, 0), (0, 0, 0), w, h,
                               offset, float(cyclic_frequency)))
        return TextureRef(len(self._tex_rows) - 1)

    def _as_texture(self, t: Union[TextureRef, Color]) -> TextureRef:
        return t if isinstance(t, TextureRef) else self.solid_texture(t)

    # ---- materials -----------------------------------------------------
    def _material(self, row: tuple) -> MaterialRef:
        self._mat_rows.append(row)
        return MaterialRef(len(self._mat_rows) - 1)

    def lambertian(self, albedo: Union[TextureRef, Color]) -> MaterialRef:
        tex = self._as_texture(albedo)
        return self._material((T.MAT_LAMBERTIAN, (0, 0, 0), 0.0, int(tex)))

    def metal(self, albedo: Color, fuzz: float) -> MaterialRef:
        fuzz = float(np.clip(fuzz, 0.0, 1.0))  # material.hpp:37
        return self._material((T.MAT_METAL, tuple(albedo), fuzz, 0))

    def dielectric(self, ref_idx: float, albedo: Color) -> MaterialRef:
        return self._material((T.MAT_DIELECTRIC, tuple(albedo),
                               float(ref_idx), 0))

    def light(self, emit: Union[TextureRef, Color]) -> MaterialRef:
        tex = self._as_texture(emit)
        return self._material((T.MAT_LIGHT, (0, 0, 0), 0.0, int(tex)))

    def isotropic(self, albedo: Union[TextureRef, Color]) -> MaterialRef:
        tex = self._as_texture(albedo)
        return self._material((T.MAT_ISOTROPIC, (0, 0, 0), 0.0, int(tex)))

    # ---- primitives ----------------------------------------------------
    def _next_scan(self) -> int:
        s = self._n_hittables
        self._n_hittables += 1
        return s

    def add_sphere(self, center, radius: float, mat: MaterialRef) -> None:
        self._spheres.append((center, center, float(radius), 0.0, 0.0,
                              int(mat), self._next_scan()))

    def add_moving_sphere(self, c0, c1, time0: float, time1: float,
                          radius: float, mat: MaterialRef) -> None:
        self._spheres.append((c0, c1, float(radius), float(time0),
                              float(time1), int(mat), self._next_scan()))

    def add_xy_rect(self, x0, x1, y0, y1, k, mat: MaterialRef) -> None:
        self._rects.append((T.RECT_XY, x0, x1, y0, y1, k, int(mat),
                            self._next_scan(), 0))

    def add_xz_rect(self, x0, x1, z0, z1, k, mat: MaterialRef) -> None:
        self._rects.append((T.RECT_XZ, x0, x1, z0, z1, k, int(mat),
                            self._next_scan(), 0))

    def add_yz_rect(self, y0, y1, z0, z1, k, mat: MaterialRef) -> None:
        self._rects.append((T.RECT_YZ, y0, y1, z0, z1, k, int(mat),
                            self._next_scan(), 0))

    def add_triangle(self, v0, v1, v2, mat: MaterialRef) -> None:
        self._tris.append((v0, v1, v2, int(mat), self._next_scan()))

    def add_box(self, p0, p1, mat: MaterialRef) -> None:
        """Six rect sides in the reference's order (box.hpp:20-25):
        xy@z1, xy@z0, xz@y1, xz@y0, yz@x1, yz@x0."""
        scan = self._next_scan()
        (x0, y0, z0), (x1, y1, z1) = p0, p1
        sides = [(T.RECT_XY, x0, x1, y0, y1, z1),
                 (T.RECT_XY, x0, x1, y0, y1, z0),
                 (T.RECT_XZ, x0, x1, z0, z1, y1),
                 (T.RECT_XZ, x0, x1, z0, z1, y0),
                 (T.RECT_YZ, y0, y1, z0, z1, x1),
                 (T.RECT_YZ, y0, y1, z0, z1, x0)]
        for sub, side in enumerate(sides):
            self._rects.append(side + (int(mat), scan, sub))

    def add_constant_medium(self, boundary, density: float,
                            albedo: Union[TextureRef, Color]) -> None:
        """boundary: ("sphere", center, radius) or ("box", p0, p1); the
        isotropic phase material is made here (constant_medium.hpp:18-27)."""
        mat = self.isotropic(albedo)
        scan = self._next_scan()
        if boundary[0] == "sphere":
            _, c, r = boundary
            self._media.append((T.MED_BOUND_SPHERE, c, float(r), (0, 0, 0),
                                (0, 0, 0), -1.0 / float(density), int(mat),
                                scan))
        elif boundary[0] == "box":
            _, p0, p1 = boundary
            self._media.append((T.MED_BOUND_BOX, (0, 0, 0), 0.0, p0, p1,
                                -1.0 / float(density), int(mat), scan))
        else:
            raise ValueError(f"unknown boundary kind {boundary[0]!r}")

    # ---- packing -------------------------------------------------------
    def build(self, pad_multiple: int = 8,
              device: Union[str, torch.device] = "cuda") -> T.Scene:
        """Pack to SoA tensors on `device`.  Every class is padded to at
        least one slot (active False) and up to a multiple of
        `pad_multiple`; media are padded to at least one."""
        dev = resolve_device(device)

        def t(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.asarray(a)).to(dev)

        def v3(rows: Sequence) -> Vec3:
            a = np.asarray(rows, np.float32).reshape(-1, 3)
            return Vec3(t(a[:, 0]), t(a[:, 1]), t(a[:, 2]))

        def padlen(n: int) -> int:
            return -(-max(n, 1) // pad_multiple) * pad_multiple

        # spheres
        ps = padlen(len(self._spheres))
        c0 = np.zeros((ps, 3), np.float32)
        c1 = np.zeros((ps, 3), np.float32)
        rad, st0, st1 = (np.zeros(ps, np.float32) for _ in range(3))
        smat = np.zeros(ps, np.int32)
        sscan = np.full(ps, 2**30, np.int32)
        sact = np.zeros(ps, bool)
        for i, (a, b, r, t0, t1, m, sc) in enumerate(self._spheres):
            c0[i], c1[i], rad[i], st0[i], st1[i] = a, b, r, t0, t1
            smat[i], sscan[i], sact[i] = m, sc, True
        spheres = T.Spheres(c0=v3(c0), c1=v3(c1), radius=t(rad),
                            time0=t(st0), time1=t(st1), mat=t(smat),
                            scan=t(sscan), active=t(sact))

        # rects
        pr = padlen(len(self._rects))
        rax = np.zeros(pr, np.int32)
        ra0, rb0, rk = (np.zeros(pr, np.float32) for _ in range(3))
        ra1, rb1 = (np.ones(pr, np.float32) for _ in range(2))
        rmat = np.zeros(pr, np.int32)
        rscan = np.full(pr, 2**30, np.int32)
        rsub = np.zeros(pr, np.int32)
        ract = np.zeros(pr, bool)
        for i, (ax, a0, a1, b0, b1, k, m, sc, sub) in enumerate(self._rects):
            rax[i], ra0[i], ra1[i], rb0[i], rb1[i], rk[i] = ax, a0, a1, b0, \
                b1, k
            rmat[i], rscan[i], rsub[i], ract[i] = m, sc, sub, True
        rects = T.Rects(axis=t(rax), a0=t(ra0), a1=t(ra1), b0=t(rb0),
                        b1=t(rb1), k=t(rk), mat=t(rmat), scan=t(rscan),
                        sub=t(rsub), active=t(ract))

        # triangles (padding: a unit right triangle at the origin)
        pt = padlen(len(self._tris))
        tv0 = np.zeros((pt, 3), np.float32)
        tv1 = np.zeros((pt, 3), np.float32)
        tv1[:, 0] = 1.0
        tv2 = np.zeros((pt, 3), np.float32)
        tv2[:, 1] = 1.0
        tmat = np.zeros(pt, np.int32)
        tscan = np.full(pt, 2**30, np.int32)
        tact = np.zeros(pt, bool)
        for i, (a, b, c, m, sc) in enumerate(self._tris):
            tv0[i], tv1[i], tv2[i] = a, b, c
            tmat[i], tscan[i], tact[i] = m, sc, True
        tris = T.Triangles(v0=v3(tv0), v1=v3(tv1), v2=v3(tv2), mat=t(tmat),
                           scan=t(tscan), active=t(tact))

        # media
        pm = max(len(self._media), 1)
        mb = np.zeros(pm, np.int32)
        mc = np.zeros((pm, 3), np.float32)
        mr = np.ones(pm, np.float32)
        mp0 = np.zeros((pm, 3), np.float32)
        mp1 = np.ones((pm, 3), np.float32)
        mnid = np.full(pm, -1.0, np.float32)
        mmat = np.zeros(pm, np.int32)
        mscan = np.full(pm, 2**30, np.int32)
        mact = np.zeros(pm, bool)
        for i, (bt, c, r, p0, p1, nid, m, sc) in enumerate(self._media):
            mb[i], mc[i], mr[i], mp0[i], mp1[i] = bt, c, r, p0, p1
            mnid[i], mmat[i], mscan[i], mact[i] = nid, m, sc, True
        media = T.Media(btype=t(mb), c=v3(mc), r=t(mr), pmin=v3(mp0),
                        pmax=v3(mp1), neg_inv_density=t(mnid), mat=t(mmat),
                        scan=t(mscan), active=t(mact))

        # materials
        nmat = max(len(self._mat_rows), 1)
        mt = np.zeros(nmat, np.int32)
        mcol = np.zeros((nmat, 3), np.float32)
        mpar = np.ones(nmat, np.float32)
        mtex = np.zeros(nmat, np.int32)
        for i, (ty, col, par, tex) in enumerate(self._mat_rows):
            mt[i], mcol[i], mpar[i], mtex[i] = ty, col, par, tex
        materials = T.Materials(mtype=t(mt), color=v3(mcol), param=t(mpar),
                                tex=t(mtex))

        # textures
        ntex = max(len(self._tex_rows), 1)
        tty = np.zeros(ntex, np.int32)
        tc1 = np.zeros((ntex, 3), np.float32)
        tc2 = np.zeros((ntex, 3), np.float32)
        tw = np.ones(ntex, np.int32)
        th = np.ones(ntex, np.int32)
        toff = np.zeros(ntex, np.int32)
        tfreq = np.ones(ntex, np.float32)
        for i, (ty, a, b, w, h, off, fr) in enumerate(self._tex_rows):
            tty[i], tc1[i], tc2[i], tw[i], th[i] = ty, a, b, w, h
            toff[i], tfreq[i] = off, fr
        textures = T.Textures(ttype=t(tty), c1=v3(tc1), c2=v3(tc2),
                              width=t(tw), height=t(th), offset=t(toff),
                              freq=t(tfreq),
                              atlas=t(np.concatenate(self._atlas, axis=0)))

        return T.Scene(spheres=spheres, rects=rects, triangles=tris,
                       media=media, materials=materials, textures=textures,
                       n_hittables=t(np.asarray(self._n_hittables, np.int32)))
