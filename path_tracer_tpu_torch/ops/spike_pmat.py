"""The nearest-sphere spike: P moving spheres against every ray, kernel K2.

Mirrors the reference's measurement spike `tools/spike_pmat.py`.  For each
ray (the (rows, 128) planes ox..dz, tm), every one of P=512 moving spheres
(`tab`, (P, 9): c0xyz, dcxyz, t0, inv_dt, r^2) is tested in t*|d|^2 key
space: a hit needs disc > 0, the first root if it is > 1e-3*|d|^2, else
the second.  The ray keeps the least key and the lowest index among keys
equal to it; `t` is that key (inf on a miss) and `meta` row 10 of `attrs`
((14, P)) at the winner (0 on a miss).

`spike_pmat` launches the CUDA kernel `csrc/spike_pmat.cu` on CUDA
tensors (counted in `spike_pmat.launches`), with RAYS_A_THREAD rays a
thread and K threads a ray from `split_for`, and runs the plain version
`spike_pmat_plain` on CPU tensors.  `work` counts the float ops these
inputs need and `bound_ms` turns them into the card's least time.  `run`
is the spike's entry point: it times the kernel at a given row count and
prints ms and Mray/s.
"""
from __future__ import annotations

import ctypes
import math
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.rng import f32
from ..core.vec import fsqrt

P = 512          # spheres
A = 14           # attribute rows
META_ROW = 10    # the attribute row written to meta
LANE = 128
TILE_ROWS = 64   # the reference's row block; run() takes multiples of it
PLAIN_CHUNK = 16384   # rays the plain version takes at a time
PLANES = ("ox", "oy", "oz", "dx", "dy", "dz", "tm")
# float ops, counted from csrc/spike_pmat.cu.  Every (ray, sphere) pair:
# the centre at tm 8, c-o 3, b 5, cc 6, disc 3 and the test 1.  Only where
# disc > 0: the sqrt, -b, the two roots, their two tests and the key's two
# selects.  Only where that gives a key: the running-min compare.  Every
# ray: |d|^2 5, the threshold 1 and the meta select 1.
PREFIX_OPS = 26
ROOT_OPS = 8
KEEP_OPS = 1
OPS_PER_RAY = 7
# The first kernel's count, every op charged to every pair (the sqrt's
# select 3, the roots 3, their tests 4, the selects 2, the compare 1 on
# top of the prefix): printed beside the count of the work the inputs need
OPS_PER_PAIR_ALL = 38

BLOCK = 256                # threads a block of the kernel
RAYS_A_THREAD = 2          # R, the rays each thread of the kernel folds
SPLITS = (1, 2, 4, 8, 16, 32)   # K, the threads a ray's fold is split over
FILL_THREADS = 1 << 20     # threads that fill the card several times over


def split_for(n_rays: int) -> int:
    """K, the threads each ray's fold is split over, for a call on n_rays
    rays: the least K whose threads (n_rays x K / RAYS_A_THREAD) fill the
    card several times over (132 SMs hold ~170,000 at 48 registers), so
    that the last wave of blocks is a small share; 32 for calls nothing
    fills.  Fixed from chip_smoke.py's timing of every K at the reference
    tool's three sizes (PERF.md)."""
    for k in SPLITS:
        if n_rays * k >= FILL_THREADS * RAYS_A_THREAD:
            return k
    return SPLITS[-1]


def _keys(tab: torch.Tensor, ox, oy, oz, dx, dy, dz, tm
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(key, disc) of every (sphere, ray) pair, (P, n) each, for rays
    given as (1, n) rows: the kernel's float ops in its order."""
    col = [tab[:, j:j + 1] for j in range(9)]       # (P, 1) each
    c0x, c0y, c0z, dcx, dcy, dcz, t0, idt, r2 = col
    a = dx * dx + dy * dy + dz * dz
    tmin_a = f32(1e-3) * a
    kmov = (tm - t0) * idt
    cx = c0x + kmov * dcx
    cy = c0y + kmov * dcy
    cz = c0z + kmov * dcz
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = b * b - a * cc
    has = disc > 0.0
    sq = fsqrt(torch.where(has, disc, 0.0))
    negb = -b
    k1 = negb - sq
    k2 = negb + sq
    key = torch.where(has & (k1 > tmin_a), k1,
                      torch.where(has & (k2 > tmin_a), k2, math.inf))
    return key, disc


def _chunks(planes):
    flat = [p.reshape(1, -1) for p in planes]
    for i in range(0, flat[0].shape[1], PLAIN_CHUNK):
        yield [p[:, i:i + PLAIN_CHUNK] for p in flat]


def spike_pmat_plain(tab: torch.Tensor, attrs: torch.Tensor,
                     *planes: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version on any device, the same float
    ops in the same order (sqrt rounded as IEEE float32), PLAIN_CHUNK rays
    at a time."""
    sh = planes[0].shape
    pio = torch.arange(P, device=tab.device).reshape(P, 1)
    t_out, meta_out = [], []
    for chunk in _chunks(planes):
        key, _ = _keys(tab, *chunk)
        m = key.min(0).values
        idx = torch.where(key == m, pio, P).min(0).values
        hit = m < math.inf
        t_out.append(m)
        meta_out.append(torch.where(
            hit, attrs[META_ROW][torch.clamp(idx, max=P - 1)], 0.0))
    return torch.cat(t_out).reshape(sh), torch.cat(meta_out).reshape(sh)


def work(tab: torch.Tensor, attrs: torch.Tensor, *planes: torch.Tensor
         ) -> Dict[str, int]:
    """The float ops one call on these inputs needs, from the plain
    version's own intermediates: the prefix on every pair, the roots on
    the pairs with disc > 0, the keep on the pairs with a key; beside it
    `ops_all`, every op charged to every pair (the first kernel's count),
    and `warps_pos`, the (32 consecutive rays, sphere) pairs in which any
    ray has disc > 0: where a warp of one-ray threads takes the branch."""
    rays = planes[0].numel()
    disc_pos = keyed = warps_pos = 0
    for chunk in _chunks(planes):
        key, disc = _keys(tab, *chunk)
        has = disc > 0.0
        disc_pos += int(has.sum())
        keyed += int((key < math.inf).sum())
        has = torch.nn.functional.pad(has, (0, -has.shape[1] % 32))
        warps_pos += int(has.reshape(P, -1, 32).any(-1).sum())
    pairs = rays * P
    return dict(rays=rays, pairs=pairs, disc_pos=disc_pos, keyed=keyed,
                warps=P * -(-rays // 32), warps_pos=warps_pos,
                ops=pairs * PREFIX_OPS + disc_pos * ROOT_OPS
                + keyed * KEEP_OPS + rays * OPS_PER_RAY,
                ops_all=pairs * OPS_PER_PAIR_ALL + rays * OPS_PER_RAY)


_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    from . import build
    lib = build.load("spike_pmat")
    if lib.spike_pmat_launch.argtypes is None:
        lib.spike_pmat_launch.argtypes = [_P] * 11 + [ctypes.c_int] * 2 \
            + [_P]
        lib.spike_pmat_launch.restype = ctypes.c_int
        lib.spike_pmat_error_string.argtypes = [ctypes.c_int]
        lib.spike_pmat_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, shape, dev, what: str) -> int:
    if t.device != dev or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"spike_pmat: {what} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def spike_pmat(tab: torch.Tensor, attrs: torch.Tensor, *planes: torch.Tensor,
               _split: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, meta) for the rays of the seven planes ox, oy, oz, dx, dy, dz,
    tm (same shape).  Launches the CUDA kernel for CUDA tensors and runs
    the plain version for CPU tensors.  `_split` forces the kernel's K,
    one of SPLITS (default `split_for`), for the card tests and
    chip_smoke.py's timing of each."""
    if len(planes) != len(PLANES):
        raise ValueError(f"spike_pmat takes the planes {PLANES}")
    dev = planes[0].device
    if dev.type == "cpu":
        return spike_pmat_plain(tab, attrs, *planes)
    if dev.type != "cuda":
        raise ValueError(f"spike_pmat: unsupported device {dev}")
    k = split_for(planes[0].numel()) if _split is None else _split
    if k not in SPLITS:
        raise ValueError(f"spike_pmat: K = {k} is not one of {SPLITS}")
    sh = tuple(planes[0].shape)
    ptrs = [_check(tab, (P, 9), dev, "tab"), _check(attrs, (A, P), dev,
                                                    "attrs")]
    ptrs += [_check(p, sh, dev, n) for p, n in zip(planes, PLANES)]
    t = torch.empty(sh, dtype=torch.float32, device=dev)
    meta = torch.empty(sh, dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.spike_pmat_launch(
        *[_P(p) for p in ptrs], _P(t.data_ptr()), _P(meta.data_ptr()),
        planes[0].numel(), k,
        _P(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"spike_pmat: CUDA launch failed: "
                           f"{lib.spike_pmat_error_string(err).decode()}")
    spike_pmat.launches += 1
    return t, meta


spike_pmat.launches = 0   # kernel launches (CUDA tensors only)


def make_inputs(rows_total: int, seed: int = 0,
                device: Union[str, torch.device] = "cuda"):
    """The spike's inputs from a numpy seed: (tab, attrs, *planes).
    Planes are 5*N(0,1); the table N(0,1) with r^2 = |N| + 0.1; attrs
    arange % 997, as the reference's `run` makes them."""
    rs = np.random.RandomState(seed)
    planes = [(rs.standard_normal((rows_total, LANE)) * 5.0).astype(
        np.float32) for _ in PLANES]
    tab = rs.standard_normal((P, 9)).astype(np.float32)
    tab[:, 8] = np.abs(tab[:, 8]) + np.float32(0.1)
    attrs = (np.arange(A * P, dtype=np.float32) % np.float32(997.0)
             ).reshape(A, P)
    dev = resolve_device(device)
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (tab, attrs, *planes))


def make_tie_inputs(rows_total: int, seed: int = 3,
                    device: Union[str, torch.device] = "cuda"):
    """Inputs whose keys tie: sphere p repeats sphere p % 4, every ray
    aims near the centre (at its time) of sphere ray % 4, and attribute
    row 10 is the sphere's index, so meta names the winning copy.  Of
    equal keys the lowest index must win: a copy below 4."""
    tab, attrs, *planes = make_inputs(rows_total, seed, device="cpu")
    tab = tab[:4].repeat(P // 4, 1)
    attrs[META_ROW] = torch.arange(P, dtype=torch.float32)
    ox, oy, oz, dx, dy, dz, tm = planes
    j = torch.arange(ox.numel()).reshape(ox.shape) % 4
    c0, dc, t0, idt = tab[j, 0:3], tab[j, 3:6], tab[j, 6], tab[j, 7]
    kmov = (tm - t0) * idt
    centre = [c0[..., q] + kmov * dc[..., q] for q in range(3)]
    aim = [centre[q] - o + 0.05 * d for q, (o, d) in
           enumerate(((ox, dx), (oy, dy), (oz, dz)))]
    dev = resolve_device(device)
    return tuple(x.contiguous().to(dev) for x in
                 (tab, attrs, ox, oy, oz, *aim, tm))


def make_edge_inputs(n_rays: int = 200, seed: int = 5,
                     device: Union[str, torch.device] = "cuda"):
    """Degenerate rays among random ones, as flat (n_rays,) planes (not a
    multiple of any block's rays): every 5th ray has d = 0 (a = 0, disc =
    0, no key); every 5th from the 1st starts at the centre of sphere 11
    at its time (k1 < 0 <= the threshold, so k2 is the key); every 5th
    from the 2nd is tangent to sphere 7, set to a still unit sphere at the
    origin (disc exactly 0, no key)."""
    tab, attrs, *planes = make_inputs(-(-n_rays // LANE), seed, device="cpu")
    planes = [p.reshape(-1)[:n_rays].clone() for p in planes]
    ox, oy, oz, dx, dy, dz, tm = planes
    for q in (dx, dy, dz):
        q[0::5] = 0.0
    c0, dc, t0, idt = tab[11, 0:3], tab[11, 3:6], tab[11, 6], tab[11, 7]
    kmov = (tm[1::5] - t0) * idt
    for q, o in enumerate((ox, oy, oz)):
        o[1::5] = c0[q] + kmov * dc[q]
    tab[7] = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0])
    for q, v in zip((ox, oy, oz, dx, dy, dz), (1.0, 0.0, -5.0, 0.0, 0.0, 1.0)):
        q[2::5] = v
    dev = resolve_device(device)
    return tuple(x.contiguous().to(dev) for x in (tab, attrs, *planes))


def bound_ms(w: Dict[str, int], fp32_ops_s: float, bytes_s: float
             ) -> Dict[str, float]:
    """The least time a card with the given FP32 peak and memory rate
    could take for one call on the inputs whose `work` is w: the ops
    these inputs need, and bytes with each input read once and each
    output written once."""
    ops = w["ops"]
    nbytes = 4 * (w["rays"] * (len(PLANES) + 2) + P * 9 + A * P)
    t_ops, t_bytes = ops / fp32_ops_s * 1e3, nbytes / bytes_s * 1e3
    return dict(ops=ops, bytes=nbytes, ops_ms=t_ops, bytes_ms=t_bytes,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def run(rows_total: int, trials: int = 3,
        device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """The spike's entry point: one warm-up call, then the best of
    `trials` timed calls (host clock around a synchronised call, as the
    reference times it) at rows_total x 128 rays; prints and returns ms
    and Mray/s."""
    dev = resolve_device(device)
    if rows_total % TILE_ROWS:
        raise ValueError(f"rows_total must be a multiple of {TILE_ROWS}")
    args = make_inputs(rows_total, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    spike_pmat(*args)
    sync()
    best = math.inf
    for _ in range(trials):
        t0 = time.perf_counter()
        spike_pmat(*args)
        sync()
        best = min(best, time.perf_counter() - t0)
    rays = rows_total * LANE
    print(f"rows={rows_total} rays={rays}: {best * 1e3:.3f} ms -> "
          f"{rays / best / 1e6:.1f} Mray/s", flush=True)
    return dict(rows=rows_total, ms=best * 1e3, mray_s=rays / best / 1e6)
