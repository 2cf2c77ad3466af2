"""Numerical-safety checks on rendered images.

NaN and Inf can enter a render through a negative sqrt argument, 0/0 in a
masked lane or log(0) in the smoke sampler, and then spread through every
later sample of the pixel.  `assert_image_finite` is the cheap check after
a render.
"""
from __future__ import annotations

import numpy as np
import torch


def assert_image_finite(img, what: str = "image") -> None:
    """Raise with the first bad pixels if an image (tensor or array) has
    NaN or Inf components."""
    arr = (img.detach().cpu().numpy() if isinstance(img, torch.Tensor)
           else np.asarray(img))
    bad = ~np.isfinite(arr)
    if bad.any():
        idx = np.argwhere(bad.any(axis=-1) if arr.ndim == 3 else bad)[:8]
        raise FloatingPointError(
            f"{what} has {int(bad.sum())} non-finite components; first bad "
            f"pixels (row, col): {idx.tolist()}")
