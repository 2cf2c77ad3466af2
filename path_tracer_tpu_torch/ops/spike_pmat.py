"""The nearest-sphere spike: P moving spheres against every ray, kernel K2.

Mirrors the reference's measurement spike `tools/spike_pmat.py`.  For each
ray (the (rows, 128) planes ox..dz, tm), every one of P=512 moving spheres
(`tab`, (P, 9): c0xyz, dcxyz, t0, inv_dt, r^2) is tested in t*|d|^2 key
space: a hit needs disc > 0, the first root if it is > 1e-3*|d|^2, else
the second.  The ray keeps the least key and the lowest index among keys
equal to it; `t` is that key (inf on a miss) and `meta` row 10 of `attrs`
((14, P)) at the winner (0 on a miss).

`spike_pmat` launches the CUDA kernel `csrc/spike_pmat.cu` on CUDA
tensors (counted in `spike_pmat.launches`) and runs the plain version
`spike_pmat_plain` on CPU tensors.  `run` is the spike's entry point: it
times the kernel at a given row count and prints ms and Mray/s.
"""
from __future__ import annotations

import ctypes
import math
import time
from typing import Dict, Tuple, Union

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
# float ops of the kernel, counted from csrc/spike_pmat.cu: per (ray,
# sphere) pair the centre at tm 8, c-o 3, b 5, cc 6, disc 3, the hit test,
# sqrt and its select 3, the two roots 3, their tests 4, the key's two
# selects 2 and the running-min compare 1; per ray |d|^2 5, the threshold 1
# and the meta select 1
OPS_PER_PAIR = 38
OPS_PER_RAY = 7


def spike_pmat_plain(tab: torch.Tensor, attrs: torch.Tensor,
                     *planes: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version on any device, the same float
    ops in the same order (sqrt rounded as IEEE float32), PLAIN_CHUNK rays
    at a time."""
    sh = planes[0].shape
    flat = [p.reshape(1, -1) for p in planes]
    col = [tab[:, j:j + 1] for j in range(9)]       # (P, 1) each
    c0x, c0y, c0z, dcx, dcy, dcz, t0, idt, r2 = col
    pio = torch.arange(P, device=tab.device).reshape(P, 1)
    t_out, meta_out = [], []
    for i in range(0, flat[0].shape[1], PLAIN_CHUNK):
        ox, oy, oz, dx, dy, dz, tm = (p[:, i:i + PLAIN_CHUNK] for p in flat)
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
        m = key.min(0).values
        idx = torch.where(key == m, pio, P).min(0).values
        hit = m < math.inf
        t_out.append(m)
        meta_out.append(torch.where(
            hit, attrs[META_ROW][torch.clamp(idx, max=P - 1)], 0.0))
    return torch.cat(t_out).reshape(sh), torch.cat(meta_out).reshape(sh)


_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    from . import build
    lib = build.load("spike_pmat")
    if lib.spike_pmat_launch.argtypes is None:
        lib.spike_pmat_launch.argtypes = [_P] * 11 + [ctypes.c_int, _P]
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


def spike_pmat(tab: torch.Tensor, attrs: torch.Tensor, *planes: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, meta) for the rays of the seven planes ox, oy, oz, dx, dy, dz,
    tm (same shape).  Launches the CUDA kernel for CUDA tensors and runs
    the plain version for CPU tensors."""
    if len(planes) != len(PLANES):
        raise ValueError(f"spike_pmat takes the planes {PLANES}")
    dev = planes[0].device
    if dev.type == "cpu":
        return spike_pmat_plain(tab, attrs, *planes)
    if dev.type != "cuda":
        raise ValueError(f"spike_pmat: unsupported device {dev}")
    sh = tuple(planes[0].shape)
    ptrs = [_check(tab, (P, 9), dev, "tab"), _check(attrs, (A, P), dev,
                                                    "attrs")]
    ptrs += [_check(p, sh, dev, n) for p, n in zip(planes, PLANES)]
    t = torch.empty(sh, dtype=torch.float32, device=dev)
    meta = torch.empty(sh, dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.spike_pmat_launch(
        *[_P(p) for p in ptrs], _P(t.data_ptr()), _P(meta.data_ptr()),
        planes[0].numel(), _P(torch.cuda.current_stream(dev).cuda_stream))
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


def bound_ms(n_rays: int, fp32_ops_s: float, bytes_s: float
             ) -> Dict[str, float]:
    """The least time a card with the given FP32 peak and memory rate
    could take for one call on n_rays rays: operations counted from the
    kernel source, bytes with each input read once and each output
    written once."""
    ops = n_rays * (P * OPS_PER_PAIR + OPS_PER_RAY)
    nbytes = 4 * (n_rays * (len(PLANES) + 2) + P * 9 + A * P)
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
