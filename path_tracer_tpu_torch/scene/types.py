"""SoA scene tensors: one packed component set per primitive class.

Mirrors the reference package's `scene/types.py` field for field, so a
scene carried across by `convert.scene_from_numpy` and one built by this
package's `SceneBuilder` have the same layout.  Boxes are six rects
(box.hpp:20-25); every primitive carries its `scan` position in the
reference's scene vector so the scan-order tie rules and the medium's
prefix clamp (render.hpp:37-49, constant_medium.hpp:52-59) survive the
per-class packing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vec import Vec3

# Material type ids (material.hpp:133-135 variant order).
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_LIGHT = 3
MAT_ISOTROPIC = 4

# Texture type ids (texture.hpp:154).
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2

# Rect axis ids: which axis the plane constant k applies to.
RECT_XY = 0
RECT_XZ = 1
RECT_YZ = 2

# Medium boundary types (constant_medium.hpp:10).
MED_BOUND_SPHERE = 0
MED_BOUND_BOX = 1


class Spheres(NamedTuple):
    """Static and moving spheres (sphere.hpp:26-117); static iff
    time0 == time1."""
    c0: Vec3
    c1: Vec3
    radius: torch.Tensor
    time0: torch.Tensor
    time1: torch.Tensor
    mat: torch.Tensor       # int32 material id
    scan: torch.Tensor      # int32 position in the reference scene vector
    active: torch.Tensor    # bool, False for padding


class Rects(NamedTuple):
    """Axis-aligned rectangles and box sides; (a, b) are the in-plane axes
    in reference order (xy: x,y; xz: x,z; yz: y,z)."""
    axis: torch.Tensor
    a0: torch.Tensor
    a1: torch.Tensor
    b0: torch.Tensor
    b1: torch.Tensor
    k: torch.Tensor
    mat: torch.Tensor
    scan: torch.Tensor
    sub: torch.Tensor       # box-side order 0..5, 0 for a standalone rect
    active: torch.Tensor


class Triangles(NamedTuple):
    """Moller-Trumbore triangles (triangle.hpp:58-100)."""
    v0: Vec3
    v1: Vec3
    v2: Vec3
    mat: torch.Tensor
    scan: torch.Tensor
    active: torch.Tensor


class Media(NamedTuple):
    """Constant-density media with a sphere or box boundary
    (constant_medium.hpp:16-83)."""
    btype: torch.Tensor
    c: Vec3
    r: torch.Tensor
    pmin: Vec3
    pmax: Vec3
    neg_inv_density: torch.Tensor
    mat: torch.Tensor
    scan: torch.Tensor
    active: torch.Tensor


class Materials(NamedTuple):
    """color: metal albedo / dielectric tint; param: metal fuzz /
    dielectric index; tex: texture of lambertian, light and isotropic."""
    mtype: torch.Tensor
    color: Vec3
    param: torch.Tensor
    tex: torch.Tensor


class Textures(NamedTuple):
    """Texture table and the image atlas (pixel 0 is the reference's
    (0,0,1) load-failure texel, texture.hpp:157); offsets in pixels."""
    ttype: torch.Tensor
    c1: Vec3
    c2: Vec3
    width: torch.Tensor
    height: torch.Tensor
    offset: torch.Tensor
    freq: torch.Tensor
    atlas: torch.Tensor     # (Npix, 3) uint8


class Scene(NamedTuple):
    spheres: Spheres
    rects: Rects
    triangles: Triangles
    media: Media
    materials: Materials
    textures: Textures
    n_hittables: torch.Tensor   # int32 scalar
