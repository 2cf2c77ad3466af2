"""Carry the reference package's scene and camera into the port.

The reference's "weights" are its `Scene` and `Camera` pytrees.  Callers
pass them with `np.asarray` applied to every leaf (so this module needs
nothing of the reference); the functions walk `_fields` and build the
port's NamedTuples of the same names, with every leaf a tensor on
`device`.  Both packages then render the very same scene, even where the
two `Camera.create` round an ulp apart.

The trees may be partial, with None at some leaves (a params or gradient
tree from `diff.params.partition`): None is carried across as None, so a
reference gradient tree compares with the port's leaf by leaf.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .core.camera import Camera
from .core.device import resolve_device
from .core.vec import Vec3
from .scene import types as T

_TYPES = {cls.__name__: cls for cls in (
    T.Scene, T.Spheres, T.Rects, T.Triangles, T.Media, T.Materials,
    T.Textures, Vec3, Camera)}


def _tree(node, device: torch.device):
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        cls = _TYPES[type(node).__name__]
        return cls(*(_tree(getattr(node, f), device) for f in node._fields))
    if node is None:
        return None
    return torch.from_numpy(np.array(node, copy=True)).to(device)


def scene_from_numpy(tree, device: Union[str, torch.device] = "cuda"
                     ) -> T.Scene:
    """A port `Scene` from a reference `Scene` whose leaves are numpy (or
    None)."""
    return _tree(tree, resolve_device(device))


def camera_from_numpy(tree) -> Camera:
    """A port `Camera` (0-d float32 tensors on the CPU, as
    `Camera.create` makes) from a reference `Camera` of numpy (or None)
    leaves."""
    return _tree(tree, torch.device("cpu"))
