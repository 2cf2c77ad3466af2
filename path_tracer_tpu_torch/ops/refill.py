"""The windowed driver's refill as a hand-written CUDA kernel.

`refill` does on the card what `wq.refill_plain`, its plain PyTorch
version, does: grant each dead lane the next chunk of the queue, bank its
finished chunk and launch the chunk's first camera ray, to the bit.  The
kernel (`refill_count` then `refill_grant` in `csrc/wave_bounce.cu`, K1's
library) is two launches a refill and replaces the ~195 ATen kernels the
plain version launches on the card.  It replaces no TPU kernel: the JAX
package's refill is jnp code that XLA fuses.

Unlike `refill_plain`, it updates the lane state and banks in place, on the
granted lanes only: a refill then reads five planes of every lane and
writes only what it grants.  A plane that shares memory with another the
kernel touches is cloned first (`_distinct`), so a carry made of shared
zero planes (`wq.zero_carry`, a deposit's emptied banks) is safe to pass.
The new counter and the no-op count go to a word of their own.
"""
from __future__ import annotations

import ctypes

import torch

from . import wave_bounce as WB

_P = ctypes.c_void_p
TILE = 1024   # lanes a block of the kernel takes (csrc: R_TILE)
# the state planes the kernel updates, in csrc's R_* order (rng apart)
ST_PLANES = ("ox", "oy", "oz", "dx", "dy", "dz", "tm", "tpx", "tpy", "tpz",
             "radx", "rady", "radz", "accx", "accy", "accz", "alive", "s",
             "bnc", "pix", "send")
N_BANK = 8


class _Args(ctypes.Structure):
    """Mirror of `struct RefillArgs` in csrc/wave_bounce.cu."""
    _fields_ = ([(n, _P) for n in ("cam", "seed", "n_chunks", "vcpp",
                                   "pix_base", "samp_base", "counter", "noop",
                                   "fix_kind")]
                + [("st", _P * len(ST_PLANES)), ("rng", _P),
                   ("bank", _P * N_BANK), ("counts", _P), ("out", _P),
                   ("n_lanes", ctypes.c_int), ("chunk", ctypes.c_int)])


def _lib() -> ctypes.CDLL:
    lib = WB._lib()
    if lib.refill_launch.argtypes is None:
        lib.refill_launch.argtypes = [_P, _P]
        lib.refill_launch.restype = ctypes.c_int
    return lib


def _distinct(fixed, planes):
    """`planes` with each one that overlaps an earlier one, or any of
    `fixed`, replaced by a clone: the kernel writes them in place."""
    spans = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
             for t in fixed]
    out = []
    for t in planes:
        lo = t.data_ptr()
        if any(lo < e and s < lo + t.numel() * t.element_size()
               for s, e in spans):
            t = t.clone()
            lo = t.data_ptr()
        spans.append((lo, lo + t.numel() * t.element_size()))
        out.append(t)
    return out


def refill(c, st: WB.WaveState, ex, counter: torch.Tensor,
           fx: WB.FixState, noop: torch.Tensor):
    """`wq.refill_plain(c, st, ex, counter, fx, noop)` on CUDA tensors, in
    place; returns (st, ex, counter, noop)
    with noop one more than given if this refill granted no chunk.  `c`
    is the call (`wq.WindowCall`), `ex` the banks (`wq.WqwExtra`).  Two
    launches on the current stream, counted in `refill.launches`."""
    dev = st.pix.device
    if dev.type != "cuda":
        raise ValueError(f"refill: the kernel takes CUDA tensors, got {dev}")
    sh = tuple(st.pix.shape)
    if len(sh) != 2 or sh[1] != WB.LANE:
        raise ValueError(f"refill: planes must be (rows, {WB.LANE}), "
                         f"got {sh}")
    f32, i64 = torch.float32, torch.int64
    chk = WB._check
    a = _Args()
    a.cam = chk(c.tables.cam, f32, (23,), dev, "cam")
    a.seed = chk(c.tables.seed, i64, (), dev, "seed")
    for name, t in (("n_chunks", c.n_chunks), ("vcpp", c.vcpp),
                    ("counter", counter), ("noop", noop)):
        setattr(a, name, chk(t, i64, (), dev, name))
    a.pix_base = chk(c.pix_base, f32, (), dev, "pix_base")
    a.samp_base = chk(c.samp_base, f32, (), dev, "samp_base")
    a.fix_kind = chk(fx.kind, f32, sh, dev, "fix.kind")
    kept = [st.wrk, st.strd, *fx]                # read or left, not written
    written = _distinct(kept, [getattr(st, n) for n in ST_PLANES]
                        + [st.rng] + list(ex))
    planes = dict(zip(ST_PLANES + ("rng",), written))
    banks = written[len(ST_PLANES) + 1:]
    for i, name in enumerate(ST_PLANES):
        a.st[i] = chk(planes[name], f32, sh, dev, name)
    a.rng = chk(planes["rng"], i64, sh, dev, "rng")
    for i, (name, t) in enumerate(zip(ex._fields, banks)):
        a.bank[i] = chk(t, f32, sh, dev, name)
    a.n_lanes = st.pix.numel()
    a.chunk = int(c.chunk)
    counts = torch.empty(max(-(-a.n_lanes // TILE), 1), dtype=torch.int32,
                         device=dev)
    out = torch.empty(2, dtype=i64, device=dev)
    a.counts, a.out = counts.data_ptr(), out.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        err = _lib().refill_launch(ctypes.byref(a), _P(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"refill: CUDA launch failed: "
                           f"{_lib().wave_bounce_error_string(err).decode()}")
    refill.launches += 2
    return (st._replace(**planes), type(ex)(*banks), out[0], out[1])


refill.launches = 0     # kernel launches (two a refill); a captured pair
#                         counts at each replay (`wq.WindowGraph`)
