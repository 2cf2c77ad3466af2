"""The windowed driver's texel service as a hand-written CUDA kernel.

`texel` does on the card what `wq.texel_service`, its plain PyTorch
version, does: hand each pending image-texture fixup of a bounce its atlas
texel under the service's budget (S_SLOTS lanes a row in a lane order
rotated by the bounce, full rows for up to rows // 8 heavy rows in a row
order rotated by it), to the bit.  The kernel (`texel_count` then
`texel_serve` in `csrc/wave_bounce.cu`, K1's library) is two launches a
bounce and replaces the ~74 ATen kernels the plain version launches on the
card.  It replaces no TPU kernel: the JAX package's service is jnp code
that XLA fuses.

Where it is handed the window's counts, the second launch also adds the
bounce's pending and served lanes to them, the numbers `count_nonzero`
gives on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import wave_bounce as WB

_P = ctypes.c_void_p
ROWS = 8       # rows a block of the kernel takes, a warp a row (csrc: T_ROWS)
SLOTS = 4      # lanes a row served in any bounce (engine/wq.py: S_SLOTS)


class _Args(ctypes.Structure):
    """Mirror of `struct TexelArgs` in csrc/wave_bounce.cu."""
    _fields_ = ([(n, _P) for n in ("kind", "idx", "atlas", "texel", "srv",
                                   "heavy", "counts", "acc")]
                + [(n, ctypes.c_int) for n in ("rows", "n_atlas", "slots",
                                               "bo", "rbo", "cap")])


def _lib() -> ctypes.CDLL:
    lib = WB._lib()
    if lib.texel_launch.argtypes is None:
        lib.texel_launch.argtypes = [_P, _P]
        lib.texel_launch.restype = ctypes.c_int
    return lib


def texel(fx: WB.FixState, k: int, atlas_flat: torch.Tensor, n_atlas: int,
          counts: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`wq.texel_service(fx, k, atlas_flat, n_atlas)` on CUDA tensors:
    (texel (rows, 128) int32, srv 0/1 f32).  `counts`, a 2-word int64 on
    the same device, takes += the bounce's lanes with a pending fixup and
    those served, in place.  Two launches on the current stream, counted
    in `texel.launches`."""
    dev = fx.kind.device
    if dev.type != "cuda":
        raise ValueError(f"texel: the kernel takes CUDA tensors, got {dev}")
    sh = tuple(fx.kind.shape)
    if len(sh) != 2 or sh[0] < 1 or sh[1] != WB.LANE:
        raise ValueError(f"texel: planes must be (rows >= 1, {WB.LANE}), "
                         f"got {sh}")
    if n_atlas < 1:
        raise ValueError(f"texel: the atlas holds {n_atlas} texels")
    chk = WB._check
    rows = sh[0]
    a = _Args()
    a.kind = chk(fx.kind, torch.float32, sh, dev, "fix.kind")
    a.idx = chk(fx.idx, torch.float32, sh, dev, "fix.idx")
    a.atlas = chk(atlas_flat, torch.int32, (n_atlas,), dev, "atlas_flat")
    if counts is not None:
        a.acc = chk(counts, torch.int64, (2,), dev, "counts")
    out = torch.empty(sh, dtype=torch.int32, device=dev)
    srv = torch.empty(sh, dtype=torch.float32, device=dev)
    heavy = torch.empty(rows, dtype=torch.int32, device=dev)
    blocks = torch.empty(-(-rows // ROWS), dtype=torch.int32, device=dev)
    a.texel, a.srv = out.data_ptr(), srv.data_ptr()
    a.heavy, a.counts = heavy.data_ptr(), blocks.data_ptr()
    # texel_service's rotations and cap for bounce k
    a.rows, a.n_atlas, a.slots = rows, n_atlas, SLOTS
    a.bo = (k * 37) % WB.LANE
    a.rbo = (k * 997) % rows
    a.cap = max(rows // 8, 1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        err = _lib().texel_launch(ctypes.byref(a), _P(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"texel: CUDA launch failed: "
                           f"{_lib().wave_bounce_error_string(err).decode()}")
    texel.launches += 2
    return out, srv


texel.launches = 0     # kernel launches (two a bounce); a captured pair
#                        counts at each replay (`wq.WindowGraph`)
