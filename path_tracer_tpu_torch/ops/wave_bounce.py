"""The bounce kernel's wrapper, its scene tables and its state types.

Mirrors the reference package's `ops/pallas/wave_bounce.py`.  `wave_bounce`
advances every lane by one path segment: on CUDA tensors it launches the
hand-written kernel `csrc/wave_bounce.cu` (built by `ops.build`), on CPU
tensors it runs the kernel's plain PyTorch version
(`bounce_core.wave_step`).  There is no fallback between the two.

State is kept in the reference's layout at this interface: (rows, 128)
planes, float32 except `rng` (int64 holding a 32-bit value); masks are
float 0/1 and pix/s/send/strd exact small integers in float32.  The
packed tables keep the reference's row layouts: sph 15 rows, rect 15,
tri 17, med 17, spec 11 x 16, cam 23.  One more table, `fold`, holds the
sphere fold's columns again as 16-byte records (`fold_table`), the form
the kernel stages in shared memory.

The kernel has three kinds of instantiation (`k1_variant`): templated for
1-4 media, one for a media count read at run time (5..MAX_MED), both with
the fold table staged in shared memory; and a global-memory variant for a
scene past either cap (more than MAX_MED media, or a fold table over
MAX_FOLD_BYTES), which reads the table in place and keeps a lane's
per-medium snapshots in a scratch plane.  All three are bit-equal to the
plain version; only the global one takes any scene the reference takes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Union

import torch

from ..core.camera import Camera
from ..core.device import resolve_device
from ..scene import types as T
from . import bounce_core
from .bounce_core import (FIX_ALBEDO, FIX_EMIT, FIX_NONE, LANE, M_MTYPE,
                          M_TEXKIND, M_TEXREF, MAX_SPECIAL_TEX)

__all__ = ["FIX_ALBEDO", "FIX_EMIT", "FIX_NONE", "LANE", "SceneTables",
           "WaveState", "WaveOut", "FixState", "pack_scene", "pack_camera",
           "zero_fix", "wave_bounce", "wave_bounce_plain"]

DEF_TILE_ROWS = 64     # lane-count quantum on the card: rows % 64 == 0
MAX_MED = 23           # media the shared-memory variants take (csrc: MAX_MED)
SPLITS = (1, 2, 4, 8, 16, 32)   # threads a lane's sphere fold can take
MAX_FOLD_BYTES = 192 * 1024     # fold tables the shared-memory variants stage


def k1_variant(n_med: int, fold_bytes: int) -> str:
    """Which K1 instantiation takes a scene of `n_med` media slots and a
    `fold_bytes`-byte fold table: "templated" for 1-4 media, "run-time"
    for 5..MAX_MED, both staging the table in shared memory; "global"
    (the table read in place, snapshots in a scratch plane, K = 1) once
    the scene passes either cap."""
    if not 1 <= n_med <= MAX_MED or fold_bytes > MAX_FOLD_BYTES:
        return "global"
    return "templated" if n_med <= 4 else "run-time"


class SceneTables(NamedTuple):
    sph: torch.Tensor        # (15, Ps) f32
    sph_segs: torch.Tensor   # (M+1, 2) i32: per media segment (static_end, end)
    rect: torch.Tensor       # (15, Pr) f32
    rect_segs: torch.Tensor  # (M+1,) i32 segment ends
    tri: torch.Tensor        # (17, Pt) f32
    tri_segs: torch.Tensor   # (M+1,) i32
    med: torch.Tensor        # (17, M) f32
    spec: torch.Tensor       # (11, MAX_SPECIAL_TEX) f32 special textures
    cam: torch.Tensor        # (23,) f32 camera + frame size (pack_camera)
    seed: int                # base seed, 32-bit
    fold: torch.Tensor       # (Ps + 2 * moving, 4) f32 (fold_table)


def _meta(scan, texref, texkind, mtype):
    scan = torch.clamp(scan.to(torch.float32), 0, 1023)
    return (scan + texref.to(torch.float32) * M_TEXREF
            + texkind.to(torch.float32) * M_TEXKIND
            + mtype.to(torch.float32) * M_MTYPE)


def _mat_info(scene: T.Scene, mat_idx: torch.Tensor):
    """(mtype, param, rgb, texref, texkind) of each primitive: rgb is the
    solid albedo, or the plain color of metal/dielectric; texref indexes
    the special-texture table for checker and image textures."""
    m, tx = scene.materials, scene.textures
    mat_idx = mat_idx.long()
    mtype = m.mtype[mat_idx].int()
    param = m.param[mat_idx].float()
    tex = m.tex[mat_idx].long()
    ttype = tx.ttype[tex].int()
    plain = (mtype == T.MAT_METAL) | (mtype == T.MAT_DIELECTRIC)
    rgb = tuple(torch.where(plain, mc[mat_idx], sc[tex])
                for mc, sc in zip(m.color, tx.c1))
    nonsolid = tx.ttype != T.TEX_SOLID
    rank = torch.cumsum(nonsolid.int(), 0) - 1
    texref = torch.where(nonsolid[tex], rank[tex], 0)
    texref = torch.clamp(texref, 0, MAX_SPECIAL_TEX - 1)
    tk = torch.where(ttype == T.TEX_CHECKER, 1,
                     torch.where(ttype == T.TEX_IMAGE, 2, 0))
    texkind = torch.where(plain, 0, tk)
    return mtype, param, rgb, texref, texkind


def _seg_key(scan, med_scans):
    """Media segment of each primitive: the number of media before it in
    scan order."""
    return (scan[:, None] > med_scans[None, :]).sum(1)


def _nonzero_inv(x):
    return torch.where(x == 0.0, 1.0, 1.0 / torch.where(x == 0.0, 1.0, x))


def fold_table(sph: torch.Tensor, sph_segs: torch.Tensor) -> torch.Tensor:
    """The sphere fold's columns as 16-byte records in table order: a
    static sphere is one record (cx, cy, cz, r^2), a moving one three,
    (cx, cy, cz, r^2), (vx, vy, vz, t0), (inv_dt, 0, 0, 0), with c the
    center at t0 and v the motion over the shutter (sph rows 0-2, 8, 3-7).
    Returns an (n_records, 4) f32 tensor on sph's device."""
    recs, start = [], 0
    for static_end, end in sph_segs.tolist():
        recs.append(sph[[0, 1, 2, 8], start:static_end].T)
        mv = sph[:, static_end:end]
        z = torch.zeros_like(mv[7])
        recs.append(torch.stack([mv[0], mv[1], mv[2], mv[8], mv[3], mv[4],
                                 mv[5], mv[6], mv[7], z, z, z], 1)
                    .reshape(-1, 4))
        start = end
    return torch.cat(recs).contiguous()


def pack_scene(scene: T.Scene,
               device: Union[str, torch.device, None] = None) -> SceneTables:
    """Pack a scene into the kernel's tables, on `device` (default: the
    scene's).  Packing runs on the CPU, once per render; sorts are stable
    as in the reference."""
    dev = torch.device(device) if device is not None else \
        scene.spheres.radius.device
    scene = T.Scene(*[_cpu(f) for f in scene])
    md = scene.media
    big = 2 ** 30
    med_scans = torch.where(md.active, md.scan, big)
    n_med = md.r.shape[0]
    f32 = torch.float32

    # ---- spheres: by (segment, moving, scan); padding last ---------------
    s = scene.spheres
    moving = ((s.time1 != s.time0) & s.active).long()
    seg = torch.where(s.active, _seg_key(s.scan, med_scans), n_med)
    scan_c = torch.where(s.active, s.scan, 2 ** 20).long()
    order = torch.argsort((seg * 4 + moving * 2) * 2 ** 21 + scan_c,
                          stable=True)
    mtype, param, rgb, texref, texkind = _mat_info(scene, s.mat)
    (c0x, c0y, c0z, c1x, c1y, c1z, rad, t0, t1, act, scan_s, mt, pr, rr, rg,
     rb, txr, txk, seg_s, mov_s) = (c[order] for c in (
         *s.c0, *s.c1, s.radius, s.time0, s.time1, s.active, s.scan, mtype,
         param, *rgb, texref, texkind, seg, moving))
    inv_dt = torch.where(t1 - t0 == 0.0, 0.0, _nonzero_inv(t1 - t0))
    dcx, dcy, dcz = (torch.where(act, c1 - c0, 0.0)
                     for c0, c1 in ((c0x, c1x), (c0y, c1y), (c0z, c1z)))
    # padding: r^2 = 0 and far away, so disc < 0 always
    c0x = torch.where(act, c0x, 1.0e9)
    r2 = torch.where(act, rad * rad, 0.0)
    sph = torch.stack([c0x, c0y, c0z, dcx, dcy, dcz, t0.to(f32), inv_dt,
                       r2, _nonzero_inv(rad), _meta(scan_s, txr, txk, mt),
                       pr, rr, rg, rb])
    sph_segs = torch.tensor(
        [[int(((seg_s < m) | ((seg_s == m) & (mov_s == 0))).sum()),
          int((seg_s <= m).sum())] for m in range(n_med + 1)],
        dtype=torch.int32)

    # ---- rects: by (segment, scan, box side) -------------------------------
    r = scene.rects
    seg_r = torch.where(r.active, _seg_key(r.scan, med_scans), n_med)
    scan_cr = torch.where(r.active, r.scan, 2 ** 20).long()
    order = torch.argsort(seg_r * 2 ** 24 + scan_cr * 8 + r.sub, stable=True)
    mtype, param, rgb, texref, texkind = _mat_info(scene, r.mat)
    (axis_r, a0, a1, b0, b1, k_r, act_r, scan_r, mt_r, pr_r, rr_r, rg_r,
     rb_r, txr_r, txk_r, seg_rs) = (c[order] for c in (
         r.axis, r.a0, r.a1, r.b0, r.b1, r.k, r.active, r.scan, mtype, param,
         *rgb, texref, texkind, seg_r))
    a0 = torch.where(act_r, a0, 1.0)   # inactive: inverted bounds never pass
    a1 = torch.where(act_r, a1, 0.0)
    rect = torch.stack([(axis_r == T.RECT_XY).to(f32),
                        (axis_r == T.RECT_XZ).to(f32),
                        (axis_r == T.RECT_YZ).to(f32), k_r.to(f32),
                        a0, a1, b0, b1, _nonzero_inv(a1 - a0),
                        _nonzero_inv(b1 - b0),
                        _meta(scan_r, txr_r, txk_r, mt_r),
                        pr_r, rr_r, rg_r, rb_r])
    rect_segs = torch.tensor([int((seg_rs <= m).sum())
                              for m in range(n_med + 1)], dtype=torch.int32)

    # ---- triangles: by (segment, scan) -------------------------------------
    tr = scene.triangles
    seg_t = torch.where(tr.active, _seg_key(tr.scan, med_scans), n_med)
    scan_ct = torch.where(tr.active, tr.scan, 2 ** 20).long()
    order = torch.argsort(seg_t * 2 ** 24 + scan_ct, stable=True)
    mtype, param, rgb, texref, texkind = _mat_info(scene, tr.mat)
    (v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z, act_t, scan_t, mt_t, pr_t,
     rr_t, rg_t, rb_t, txr_t, txk_t, seg_ts) = (c[order] for c in (
         *tr.v0, *tr.v1, *tr.v2, tr.active, tr.scan, mtype, param, *rgb,
         texref, texkind, seg_t))
    # inactive: zero edge, so |a| < eps and it never hits
    e1x, e1y, e1z = (torch.where(act_t, v1 - v0, 0.0)
                     for v0, v1 in ((v0x, v1x), (v0y, v1y), (v0z, v1z)))
    e2x, e2y, e2z = v2x - v0x, v2y - v0y, v2z - v0z
    tri = torch.stack([v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
                       e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
                       e1x * e2y - e1y * e2x,
                       _meta(scan_t, txr_t, txk_t, mt_t),
                       pr_t, rr_t, rg_t, rb_t])
    tri_segs = torch.tensor([int((seg_ts <= m).sum())
                             for m in range(n_med + 1)], dtype=torch.int32)

    # ---- media, in scan order (the builder adds them sorted) ---------------
    mtype, param, rgb, texref, texkind = _mat_info(scene, md.mat)
    meta_m = _meta(torch.where(md.active, md.scan, 1023), texref, texkind,
                   mtype)
    med = torch.stack([md.btype.to(f32), *md.c, md.r, *md.pmin, *md.pmax,
                       md.neg_inv_density, md.active.to(f32), meta_m, *rgb])

    # ---- special textures (checker / image) by direct index ---------------
    tx = scene.textures
    nonsolid = tx.ttype != T.TEX_SOLID
    rank = torch.cumsum(nonsolid.long(), 0) - 1
    slot = torch.where(nonsolid & (rank < MAX_SPECIAL_TEX), rank,
                       MAX_SPECIAL_TEX)
    cols = torch.stack([tx.ttype.to(f32), *tx.c1, *tx.c2,
                        tx.width.to(f32), tx.height.to(f32),
                        tx.offset.to(f32), tx.freq])
    spec = torch.zeros((11, MAX_SPECIAL_TEX + 1), dtype=f32)
    spec[:, slot] = cols          # solid textures land in the cut column
    spec = spec[:, :MAX_SPECIAL_TEX].contiguous()

    to = lambda x: x.contiguous().to(dev)
    return SceneTables(sph=to(sph), sph_segs=to(sph_segs), rect=to(rect),
                       rect_segs=to(rect_segs), tri=to(tri),
                       tri_segs=to(tri_segs), med=to(med), spec=to(spec),
                       cam=torch.zeros(23, dtype=f32, device=dev), seed=0,
                       fold=to(fold_table(sph, sph_segs)))


def _cpu(node):
    if isinstance(node, tuple):
        return type(node)(*[_cpu(x) for x in node])
    return node.cpu()


def pack_camera(cam: Camera, width: int, height: int,
                device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """The camera and frame size as the kernel's 23 floats, on `device`."""
    vals = [*cam.origin, *cam.lower_left_corner, *cam.horizontal,
            *cam.vertical, *cam.u, *cam.v, cam.lens_radius, cam.time0,
            cam.time1]
    out = torch.stack([v.to(torch.float32).reshape(()) for v in vals]
                      + [torch.tensor(float(width)),
                         torch.tensor(float(height))])
    return out.to(resolve_device(device))


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

# read-write float32 planes, in the kernel's order (rng, int64, goes apart)
F_RW = ("ox", "oy", "oz", "dx", "dy", "dz", "tm", "tpx", "tpy", "tpz",
        "radx", "rady", "radz", "accx", "accy", "accz", "alive", "s", "bnc",
        "wrk")
F_RO = ("pix", "send", "strd")
FIX_FIELDS = ("kind", "idx", "fwx", "fwy", "fwz")


class WaveState(NamedTuple):
    """Per-lane path state, all (rows, 128)."""
    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    tm: torch.Tensor
    rng: torch.Tensor
    tpx: torch.Tensor
    tpy: torch.Tensor
    tpz: torch.Tensor
    radx: torch.Tensor
    rady: torch.Tensor
    radz: torch.Tensor
    accx: torch.Tensor
    accy: torch.Tensor
    accz: torch.Tensor
    alive: torch.Tensor
    s: torch.Tensor
    bnc: torch.Tensor
    wrk: torch.Tensor
    pix: torch.Tensor
    send: torch.Tensor
    strd: torch.Tensor


class FixState(NamedTuple):
    """Pending image-texture fixups, (rows, 128) f32: the last call's fix
    outputs, carried until the driver's texel service covers them."""
    kind: torch.Tensor     # FIX_NONE / FIX_ALBEDO / FIX_EMIT
    idx: torch.Tensor      # atlas pixel index (exact int in f32)
    fwx: torch.Tensor
    fwy: torch.Tensor
    fwz: torch.Tensor


class WaveOut(NamedTuple):
    state: WaveState       # pix/send/strd passed through
    fix: FixState
    win: torch.Tensor      # ((term*4 + cls)*1024 + scan) + 1, 0 = not advanced
    t_hit: torch.Tensor    # winner t, 0 without a hit


def zero_fix(rows: int, device: Union[str, torch.device]) -> FixState:
    z = torch.zeros((rows, LANE), dtype=torch.float32, device=device)
    return FixState(z, z, z, z, z)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


class _Args(ctypes.Structure):
    """Mirror of `struct WaveArgs` in csrc/wave_bounce.cu."""
    _fields_ = ([(n, _P) for n in ("sph", "sph_segs", "rect", "rect_segs",
                                   "tri", "tri_segs", "med", "spec", "cam")]
                + [("f_in", _P * (len(F_RW) + len(F_RO))), ("rng_in", _P),
                   ("fix_in", _P * 5), ("texel", _P), ("srv", _P),
                   ("f_out", _P * len(F_RW)), ("rng_out", _P),
                   ("fix_out", _P * 5), ("win", _P), ("t_hit", _P),
                   ("n_lanes", ctypes.c_int), ("p_sph", ctypes.c_int),
                   ("p_rect", ctypes.c_int), ("p_tri", ctypes.c_int),
                   ("n_med", ctypes.c_int), ("max_depth", ctypes.c_int),
                   ("attenuate", ctypes.c_int), ("seed", ctypes.c_uint),
                   ("t_min", ctypes.c_float), ("fold", _P),
                   ("fold_recs", ctypes.c_int), ("split", ctypes.c_int),
                   ("global_", ctypes.c_int), ("scratch", _P)])


FILL_THREADS = 1 << 16  # fold threads that keep the card busy
MAX_AUTO_SPLIT = 8      # past it, the per-lane rest of a tile idles
NARROW_SPLIT = 4        # for calls no K up to MAX_AUTO_SPLIT fills


def split_for(n_lanes: int) -> int:
    """K, the threads each lane's sphere fold is split across: the least
    of SPLITS up to MAX_AUTO_SPLIT with lanes x K >= FILL_THREADS, else
    NARROW_SPLIT.  A tile holds 256 / K lanes and the per-lane rest of the
    segment runs one thread a lane, so a large K leaves most of a block
    idle there.  The rule follows chip_smoke.py's timing of every K at the
    paths' widths (PERF.md)."""
    for k in SPLITS:
        if k <= MAX_AUTO_SPLIT and n_lanes * k >= FILL_THREADS:
            return k
    return NARROW_SPLIT


def _check(t: torch.Tensor, dtype, shape, dev, what: str) -> int:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"wave_bounce: {what} must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def _lib() -> ctypes.CDLL:
    from . import build
    lib = build.load("wave_bounce")
    if lib.wave_bounce_launch.argtypes is None:
        lib.wave_bounce_launch.argtypes = [_P, _P]
        lib.wave_bounce_launch.restype = ctypes.c_int
        lib.wave_bounce_error_string.argtypes = [ctypes.c_int]
        lib.wave_bounce_error_string.restype = ctypes.c_char_p
        lib.wave_bounce_occupancy.argtypes = [_P, _P]
        lib.wave_bounce_occupancy.restype = ctypes.c_int
    return lib


def occupancy(n_med: int, split: int, fold_recs: int) -> int:
    """Resident blocks an SM of the kernel instantiated for `n_med` media
    at split K with a fold table of `fold_recs` records (the variant
    `k1_variant` picks; the global one only at K = 1), as the CUDA
    runtime reports it."""
    lib = _lib()
    a = _Args()
    a.n_med, a.split, a.fold_recs = n_med, split, fold_recs
    a.global_ = int(k1_variant(n_med, fold_recs * 16) == "global")
    blocks = ctypes.c_int(0)
    err = lib.wave_bounce_occupancy(ctypes.byref(a), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"wave_bounce: occupancy query failed: "
                           f"{lib.wave_bounce_error_string(err).decode()}")
    return blocks.value


def _launch(tables: SceneTables, st: WaveState, fix: FixState,
            texel: torch.Tensor, srv: torch.Tensor, t_min: float,
            max_depth: int, attenuate: bool, split: Optional[int] = None):
    lib = _lib()
    dev = st.ox.device
    sh = tuple(st.ox.shape)
    f32 = torch.float32
    n_med = tables.med.shape[1]
    a = _Args()
    for name, rows_ in (("sph", 15), ("rect", 15), ("tri", 17), ("med", 17)):
        t = getattr(tables, name)
        setattr(a, name, _check(t, f32, (rows_, t.shape[1]), dev, name))
    a.sph_segs = _check(tables.sph_segs, torch.int32, (n_med + 1, 2), dev,
                        "sph_segs")
    a.rect_segs = _check(tables.rect_segs, torch.int32, (n_med + 1,), dev,
                         "rect_segs")
    a.tri_segs = _check(tables.tri_segs, torch.int32, (n_med + 1,), dev,
                        "tri_segs")
    a.spec = _check(tables.spec, f32, (11, MAX_SPECIAL_TEX), dev, "spec")
    n_rec = tables.fold.shape[0]
    variant = k1_variant(n_med, n_rec * 16)
    a.fold = _check(tables.fold, f32, (n_rec, 4), dev, "fold")
    if a.fold % 16:
        raise ValueError("wave_bounce: the fold table must be 16-byte "
                         "aligned for its bulk copy")
    a.fold_recs = n_rec
    a.cam = _check(tables.cam, f32, (23,), dev, "cam")
    for i, name in enumerate(F_RW + F_RO):
        a.f_in[i] = _check(getattr(st, name), f32, sh, dev, name)
    a.rng_in = _check(st.rng, torch.int64, sh, dev, "rng")
    for i, name in enumerate(FIX_FIELDS):
        a.fix_in[i] = _check(getattr(fix, name), f32, sh, dev, f"fix.{name}")
    a.texel = _check(texel, torch.int32, sh, dev, "texel")
    a.srv = _check(srv, f32, sh, dev, "srv")
    f_out = [torch.empty(sh, dtype=f32, device=dev) for _ in F_RW]
    rng_out = torch.empty(sh, dtype=torch.int64, device=dev)
    fix_out = [torch.empty(sh, dtype=f32, device=dev) for _ in FIX_FIELDS]
    win = torch.empty(sh, dtype=f32, device=dev)
    t_hit = torch.empty(sh, dtype=f32, device=dev)
    for i, t in enumerate(f_out):
        a.f_out[i] = t.data_ptr()
    for i, t in enumerate(fix_out):
        a.fix_out[i] = t.data_ptr()
    a.rng_out, a.win, a.t_hit = (rng_out.data_ptr(), win.data_ptr(),
                                 t_hit.data_ptr())
    a.n_lanes = st.ox.numel()
    scratch = None
    if variant == "global":
        # one lane a thread; the sphere, rect and triangle folds'
        # per-medium snapshots of every lane, allocated per call
        if split not in (None, 1):
            raise ValueError(f"wave_bounce: a scene past the shared-memory "
                             f"caps folds at K = 1, not {split}")
        a.split, a.global_ = 1, 1
        scratch = torch.empty(max(3 * n_med * a.n_lanes, 1), dtype=f32,
                              device=dev)
        a.scratch = scratch.data_ptr()
    else:
        a.split = split_for(a.n_lanes) if split is None else split
    if a.split not in SPLITS:
        raise ValueError(f"wave_bounce: split {a.split} is not one of "
                         f"{SPLITS}")
    a.p_sph, a.p_rect, a.p_tri = (tables.sph.shape[1], tables.rect.shape[1],
                                  tables.tri.shape[1])
    a.n_med, a.max_depth, a.attenuate = n_med, int(max_depth), int(attenuate)
    a.seed = int(tables.seed) & 0xFFFFFFFF
    a.t_min = float(t_min)
    stream = torch.cuda.current_stream(dev)
    events = wave_bounce.events
    if events is not None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
    err = lib.wave_bounce_launch(ctypes.byref(a), _P(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"wave_bounce: CUDA launch failed: "
                           f"{lib.wave_bounce_error_string(err).decode()}")
    wave_bounce.launches += 1
    if events is not None:
        end.record(stream)
        events.append((a.n_lanes, start, end))
    rw = dict(zip(F_RW, f_out), rng=rng_out)
    return (tuple(rw[n] for n in WaveState._fields[:21]) + tuple(fix_out)
            + (win, t_hit))


def _wave_out(st: WaveState, outs) -> WaveOut:
    return WaveOut(state=WaveState(*outs[:21], pix=st.pix, send=st.send,
                                   strd=st.strd),
                   fix=FixState(*outs[21:26]), win=outs[26], t_hit=outs[27])


def wave_bounce_plain(tables: SceneTables, st: WaveState, fix: FixState,
                      texel: torch.Tensor, srv: torch.Tensor, *,
                      t_min: float, max_depth: int,
                      attenuate: bool) -> WaveOut:
    """The kernel's plain PyTorch version on any device: what
    `wave_bounce` runs for CPU tensors, and the yardstick the kernel is
    held against on the card."""
    return _wave_out(st, bounce_core.wave_step(
        tables, st, fix, texel, srv, t_min=t_min, max_depth=max_depth,
        attenuate=attenuate))


def wave_bounce(tables: SceneTables, st: WaveState,
                fix: Optional[FixState] = None,
                texel: Optional[torch.Tensor] = None,
                srv: Optional[torch.Tensor] = None, *, t_min: float,
                max_depth: int, attenuate: bool,
                tile_rows: int = DEF_TILE_ROWS,
                _split: Optional[int] = None) -> WaveOut:
    """One bounce for every lane.  The lane count is rows*128 with rows a
    multiple of tile_rows.  `fix` is the previous call's pending fixups
    (None for the first bounce), `texel` the int32 atlas texels the
    driver's texel service resolved for them (R | G<<8 | B<<16) and `srv`
    the 0/1 mask of fixups it covered; lanes with an uncovered pending
    fixup stall this call.  Launches the CUDA kernel for CUDA tensors
    (counted in `wave_bounce.launches`) and runs the plain version for CPU
    tensors.  `_split` forces K (see `split_for`) for the kernel's
    tests."""
    rows = st.ox.shape[0]
    if rows % tile_rows:
        raise ValueError(f"rows {rows} is not a multiple of tile_rows "
                         f"{tile_rows}")
    dev = st.ox.device
    if fix is None:
        fix = zero_fix(rows, dev)
        texel = torch.zeros((rows, LANE), dtype=torch.int32, device=dev)
    if srv is None:
        srv = torch.ones((rows, LANE), dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        return _wave_out(st, _launch(tables, st, fix, texel, srv, t_min,
                                     max_depth, attenuate, split=_split))
    if dev.type == "cpu":
        return wave_bounce_plain(tables, st, fix, texel, srv, t_min=t_min,
                                 max_depth=max_depth, attenuate=attenuate)
    raise ValueError(f"wave_bounce: unsupported device {dev}")


wave_bounce.launches = 0   # kernel launches (CUDA tensors only)
wave_bounce.events = None  # a list to collect (lanes, start, end), the CUDA
#                            events around each launch; None = off
