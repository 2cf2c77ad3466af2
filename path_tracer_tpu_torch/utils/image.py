"""Image output with the reference's tone mapping (main.cpp:16-59).

Gamma 2.0 via sqrt, clamp to [0, 0.999], scale by 256, truncate, and flip
vertically (the framebuffer is y-up, PNG rows run top-down).  The PNG
writer needs only the standard library.  `dump_ppm` mirrors
dump_image_ppm (main.cpp:17-31).
"""
from __future__ import annotations

import io
import struct
import zlib

import numpy as np


def tonemap(fb) -> np.ndarray:
    """(H, W, 3) linear f32, y-up -> (H, W, 3) uint8, y-down."""
    v = np.sqrt(np.asarray(fb, np.float32))     # gamma 2.0 (main.cpp:44-49)
    v = np.clip(v, 0.0, 0.999)
    pix = (256.0 * v).astype(np.int32).astype(np.uint8)
    return pix[::-1]                            # flip y (main.cpp:41)


def save_png(path: str, fb) -> None:
    """Tone-map `fb` and write it as an 8-bit RGB PNG."""
    pix = tonemap(fb)
    h, w, _ = pix.shape
    raw = b"".join(b"\x00" + pix[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def dump_ppm(fb) -> str:
    """P3 PPM text, rows top-down like dump_image_ppm (main.cpp:17-31)."""
    pix = tonemap(fb).astype(np.int32)
    h, w, _ = pix.shape
    out = io.StringIO()
    out.write(f"P3\n{w} {h}\n255\n")
    for row in pix.reshape(h * w, 3):
        out.write(f"{row[0]} {row[1]} {row[2]}\n")
    return out.getvalue()
