"""The five staged scene presets, the reference's full final scene, and
the final scene of "Ray Tracing: The Next Week".

The first six mirror the reference package's `scene/presets.py`: the same
builder calls in the same order, the same host-side xorshift (`HostRng`)
in float32, and the same image fallback (`PT_REFERENCE_IMAGES`, else a
procedural logo), so every array equals the reference package's build.
`next_week_final` is the port's own; its calls pack to the same tables
through either package's `SceneBuilder`.

`build_final_scene` reproduces the reference's main.cpp:61-186.  GCC
evaluates `point(a + 0.9f*rng(), 0.2f, b + 0.9f*rng())` (main.cpp:82) right
to left, so the z jitter is drawn before the x jitter.
"""
from __future__ import annotations

import os
from typing import Callable, NamedTuple, Tuple, Union

import numpy as np
import torch

from ..core.camera import Camera
from .builder import SceneBuilder
from .types import Scene

# directory of the reference's image assets; without it (or without the
# file) the procedural logo stands in
REFERENCE_IMAGES = os.environ.get("PT_REFERENCE_IMAGES", "")

Device = Union[str, torch.device]


class HostRng:
    """Host-side LocalPseudoRNG (rtweekend.hpp:33-57, xorshift.hpp:72-74)
    in float32, for deterministic scene construction."""

    MASK = 0xFFFFFFFF

    def __init__(self, state: int = 2463534242):
        self.s = state & self.MASK

    def _next(self) -> int:
        s = self.s
        s ^= (s >> 7)
        s = (s ^ ((s << 1) & self.MASK)) & self.MASK
        s ^= (s >> 9)
        self.s = s
        return s

    def float_t(self, lo: float = 0.0, hi: float = 1.0) -> np.float32:
        f = np.float32(self._next()) * np.float32(1.0 / (1 << 32))
        if lo == 0.0 and hi == 1.0:
            return f
        return np.float32(lo) + (np.float32(hi) - np.float32(lo)) * f

    def vec_t(self, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
        v = np.array([self.float_t(), self.float_t(), self.float_t()],
                     np.float32)
        if lo == 0.0 and hi == 1.0:
            return v
        # vec_t(min, max) = vec_t() * scale + min (rtweekend.hpp:54-57)
        return v * np.float32(hi - lo) + np.float32(lo)


class Preset(NamedTuple):
    name: str
    width: int
    height: int
    spp: int
    max_depth: int
    build: Callable[..., Tuple[Scene, Camera]]   # build(device="cuda")


def _camera(look_from, look_at, vfov, aspect, aperture, focus=None,
            t0=0.0, t1=0.0) -> Camera:
    if focus is None:
        d = np.asarray(look_at, np.float32) - np.asarray(look_from, np.float32)
        focus = float(np.sqrt(np.sum(d * d)))
    return Camera.create(look_from, look_at, (0.0, 1.0, 0.0), vfov, aspect,
                         aperture, focus, t0, t1)


def _build_three_spheres(device: Device = "cuda") -> Tuple[Scene, Camera]:
    sb = SceneBuilder()
    ground = sb.lambertian((0.8, 0.8, 0.0))
    center = sb.lambertian((0.1, 0.2, 0.5))
    right = sb.metal((0.8, 0.6, 0.2), 0.3)
    sb.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    sb.add_sphere((0.0, 0.0, -1.0), 0.5, center)
    sb.add_sphere((1.0, 0.0, -1.0), 0.5, right)
    cam = _camera((0, 0.5, 1.5), (0, 0, -1), 60.0, 200.0 / 100.0, 0.0)
    return sb.build(device=device), cam


THREE_SPHERES = Preset("three_spheres", 200, 100, 10, 8, _build_three_spheres)


def _build_rtiow_cover(device: Device = "cuda") -> Tuple[Scene, Camera]:
    sb = SceneBuilder()
    sb.add_sphere((0, -1000, 0), 1000, sb.lambertian((0.5, 0.5, 0.5)))
    rng = HostRng()
    for a in range(-7, 7):
        for b in range(-7, 7):
            choose = rng.float_t()
            cx = np.float32(a) + np.float32(0.9) * rng.float_t()
            cz = np.float32(b) + np.float32(0.9) * rng.float_t()
            center = (float(cx), 0.2, float(cz))
            d = np.array(center, np.float32) - np.array([4, 0.2, 0], np.float32)
            if float(np.sqrt(np.sum(d * d))) <= 0.9:
                continue
            if choose < 0.6:
                albedo = rng.vec_t() * rng.vec_t()
                sb.add_sphere(center, 0.2, sb.lambertian(tuple(albedo)))
            elif choose < 0.85:
                albedo = rng.vec_t(0.5, 1.0)
                fuzz = float(rng.float_t(0, 0.5))
                sb.add_sphere(center, 0.2, sb.metal(tuple(albedo), fuzz))
            else:
                sb.add_sphere(center, 0.2, sb.dielectric(1.5, (1, 1, 1)))
    sb.add_sphere((0, 1, 0), 1.0, sb.dielectric(1.5, (1, 1, 1)))
    sb.add_sphere((-4, 1, 0), 1.0, sb.lambertian((0.4, 0.2, 0.1)))
    sb.add_sphere((4, 1, 0), 1.0, sb.metal((0.7, 0.6, 0.5), 0.0))
    cam = _camera((13, 2, 3), (0, 0, 0), 20.0, 400.0 / 225.0, 0.1, focus=10.0)
    return sb.build(device=device), cam


RTIOW_COVER = Preset("rtiow_cover", 400, 225, 50, 50, _build_rtiow_cover)


def _build_cornell(device: Device = "cuda") -> Tuple[Scene, Camera]:
    sb = SceneBuilder()
    red = sb.lambertian((0.65, 0.05, 0.05))
    white = sb.lambertian((0.73, 0.73, 0.73))
    green = sb.lambertian((0.12, 0.45, 0.15))
    light = sb.light((15.0, 15.0, 15.0))
    sb.add_yz_rect(0, 555, 0, 555, 555, green)   # left
    sb.add_yz_rect(0, 555, 0, 555, 0, red)       # right
    sb.add_xz_rect(213, 343, 227, 332, 554, light)
    sb.add_xz_rect(0, 555, 0, 555, 0, white)     # floor
    sb.add_xz_rect(0, 555, 0, 555, 555, white)   # ceiling
    sb.add_xy_rect(0, 555, 0, 555, 555, white)   # back
    sb.add_box((130, 0, 65), (295, 165, 230), white)
    sb.add_box((265, 0, 295), (430, 330, 460), white)
    cam = _camera((278, 278, -800), (278, 278, 0), 40.0, 1.0, 0.0)
    return sb.build(device=device), cam


CORNELL_BOX = Preset("cornell_box", 400, 400, 100, 50, _build_cornell)


def _procedural_logo(w: int = 64, h: int = 64) -> np.ndarray:
    """Stand-in image when the reference's assets are not on disk."""
    yy, xx = np.mgrid[0:h, 0:w]
    r = ((xx * 255) // max(w - 1, 1)).astype(np.uint8)
    g = ((yy * 255) // max(h - 1, 1)).astype(np.uint8)
    b = (((xx // 8 + yy // 8) % 2) * 255).astype(np.uint8)
    return np.stack([r, g, b], axis=-1)


def _image_source(name: str):
    path = os.path.join(REFERENCE_IMAGES, name)
    if REFERENCE_IMAGES and os.path.exists(path):
        return path
    return _procedural_logo()


def _build_textured_motion(device: Device = "cuda") -> Tuple[Scene, Camera]:
    sb = SceneBuilder()
    checker = sb.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    sb.add_sphere((0, -1000, 0), 1000, sb.lambertian(checker))
    img = sb.image_texture(_image_source("Xilinx.jpg"))
    sb.add_sphere((0, 1, 0), 1.0, sb.lambertian(img))
    rng = HostRng(12345)
    for a in range(-4, 5):
        for b in range(-4, 5):
            if a == 0 and b == 0:
                continue
            c0 = (float(a), 0.25, float(b))
            c1 = (float(a), 0.25 + float(rng.float_t(0, 0.5)), float(b))
            albedo = rng.vec_t() * rng.vec_t()
            sb.add_moving_sphere(c0, c1, 0.0, 1.0, 0.25,
                                 sb.lambertian(tuple(albedo)))
    cam = _camera((13, 2, 3), (0, 0, 0), 25.0, 600.0 / 400.0, 0.02,
                  t0=0.0, t1=1.0)
    return sb.build(device=device), cam


TEXTURED_MOTION = Preset("textured_motion", 600, 400, 200, 50,
                         _build_textured_motion)


def build_final_scene(aspect: float, device: Device = "cuda"
                      ) -> Tuple[Scene, Camera]:
    sb, cam = final_scene_builder(aspect)
    return sb.build(device=device), cam


def final_scene_builder(aspect: float) -> Tuple[SceneBuilder, Camera]:
    """The final scene's builder before packing, and its camera."""
    sb = SceneBuilder()
    # checkered ground (main.cpp:70-73); main.cpp:74's second checker is
    # never used by a hittable and is skipped
    t = sb.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    sb.add_sphere((0, -1000, 0), 1000, sb.lambertian(t))

    rng = HostRng()  # default seed, main.cpp:76
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose_mat = rng.float_t()                         # main.cpp:80
            cz = np.float32(b) + np.float32(0.9) * rng.float_t()
            cx = np.float32(a) + np.float32(0.9) * rng.float_t()
            center = np.array([cx, np.float32(0.2), cz], np.float32)
            d = center - np.array([4, 0.2, 0], np.float32)
            if not float(np.sqrt(np.float32(np.sum(d * d)))) > 0.9:
                continue                                        # main.cpp:84
            c = tuple(map(float, center))
            if choose_mat < 0.4:                                # main.cpp:85
                albedo = rng.vec_t() * rng.vec_t()
                sb.add_sphere(c, 0.2, sb.lambertian(tuple(albedo)))
            elif choose_mat < 0.8:                              # main.cpp:90
                albedo = rng.vec_t() * rng.vec_t()
                dy = rng.float_t(0, 0.25)
                c2 = (float(center[0]), float(center[1] + dy),
                      float(center[2]))
                sb.add_moving_sphere(c, c2, 0.0, 1.0, 0.2,
                                     sb.lambertian(tuple(albedo)))
            elif choose_mat < 0.95:                             # main.cpp:96
                albedo = rng.vec_t(0.5, 1.0)
                fuzz = float(rng.float_t(0, 0.5))
                sb.add_sphere(c, 0.2, sb.metal(tuple(albedo), fuzz))
            else:                                               # main.cpp:102
                sb.add_sphere(c, 0.2, sb.dielectric(1.5, (1.0, 1.0, 1.0)))

    # pyramid (main.cpp:113-126)
    sb.add_triangle((6.5, 0.0, 1.30), (6.25, 0.50, 1.05), (6.5, 0.0, 0.80),
                    sb.lambertian((0.68, 0.50, 0.1)))
    sb.add_triangle((6.0, 0.0, 1.30), (6.25, 0.50, 1.05), (6.5, 0.0, 1.30),
                    sb.lambertian((0.89, 0.73, 0.29)))
    sb.add_triangle((6.5, 0.0, 0.80), (6.25, 0.50, 1.05), (6.0, 0.0, 0.80),
                    sb.lambertian((0.0, 0.0, 1.0)))
    sb.add_triangle((6.0, 0.0, 0.80), (6.25, 0.50, 1.05), (6.0, 0.0, 1.30),
                    sb.lambertian((0.0, 0.0, 1.0)))

    # glowing ball (main.cpp:129-130)
    sb.add_sphere((4, 1, 0), 0.2, sb.light((10.0, 0.0, 10.0)))

    # image-textured rect and big spheres (main.cpp:133-143)
    xil = sb.image_texture(_image_source("Xilinx.jpg"))
    sb.add_xy_rect(2, 4, 0, 1, -1, sb.lambertian(xil))
    sb.add_sphere((4, 1, 2.25), 1.0, sb.lambertian(xil))
    sb.add_sphere((0, 1, 0), 1.0, sb.dielectric(1.5, (1.0, 0.5, 0.5)))
    sb.add_sphere((-4, 1, 0), 1.0, sb.lambertian((0.4, 0.2, 0.1)))
    sb.add_sphere((0, 1, -2.25), 1.0, sb.metal((0.7, 0.6, 0.5), 0.0))

    # SYCL-logo sphere (main.cpp:145-149), cyclic frequency 5
    sycl_t = sb.image_texture(_image_source("SYCL.png"), 5.0)
    sb.add_sphere((-60, 3, 5), 4.0, sb.lambertian(sycl_t))

    # metal monolith box (main.cpp:152-154)
    sb.add_box((6.5, 0, -1.5), (7.0, 3.0, -1.0),
               sb.metal((0.7, 0.6, 0.5), 0.25))

    # smoke ball (main.cpp:156-161)
    sb.add_constant_medium(("sphere", (5, 1, 3.5), 1.0), 1.0, (1.0, 1.0, 1.0))

    cam = _camera((13, 3, 3), (0, -1, 0), 40.0, aspect, 0.04, t0=0.0, t1=1.0)
    return sb, cam


def _build_final(device: Device = "cuda") -> Tuple[Scene, Camera]:
    return build_final_scene(800.0 / 600.0, device=device)


FINAL_SCENE = Preset("final_scene", 800, 600, 500, 50, _build_final)


def next_week_final_builder(sb=None) -> Tuple[SceneBuilder, Camera]:
    """The final scene of "Ray Tracing: The Next Week" (chapter "A Scene
    Testing All New Features", `final_scene(800, 10000, 40)`), its calls
    made on `sb` (default: a new `SceneBuilder`) in the book's object
    order, which decides scan indices, ties and each medium's clamp; and
    its camera.  Departures from the book, each with the same work or
    none: the 1,000 small spheres' `rotate_y(15)` and `translate` are
    baked into their centres (a rotated sphere is the same sphere, and
    their solid texture reads no (u, v)); no BVH (linear folds find the
    same nearest hit); the noise texture is its mean, a solid grey 0.5;
    the procedural logo stands in for `earthmap.jpg`; a miss takes the
    program's sky, where the book's background is black (a miss ends the
    path either way); and the box heights and sphere centres come from
    `HostRng` at its default state, with the book's distributions."""
    sb = SceneBuilder() if sb is None else sb
    rng = HostRng()
    # 20x20 ground boxes, 100 wide, heights ~ U(1, 101)
    ground = sb.lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            x0, z0 = -1000.0 + 100.0 * i, -1000.0 + 100.0 * j
            y1 = float(rng.float_t(1.0, 101.0))
            sb.add_box((x0, 0.0, z0), (x0 + 100.0, y1, z0 + 100.0), ground)
    sb.add_xz_rect(123, 423, 147, 412, 554, sb.light((7.0, 7.0, 7.0)))
    sb.add_moving_sphere((400, 400, 200), (430, 400, 200), 0.0, 1.0, 50,
                         sb.lambertian((0.7, 0.3, 0.1)))
    sb.add_sphere((260, 150, 45), 50, sb.dielectric(1.5, (1.0, 1.0, 1.0)))
    sb.add_sphere((0, 150, 145), 50, sb.metal((0.8, 0.8, 0.9), 1.0))
    # a glass ball filled with blue smoke, then a thin fog around everything
    # (the fog's boundary is no hittable)
    sb.add_sphere((360, 150, 145), 70, sb.dielectric(1.5, (1.0, 1.0, 1.0)))
    sb.add_constant_medium(("sphere", (360, 150, 145), 70), 0.2,
                           (0.2, 0.4, 0.9))
    sb.add_constant_medium(("sphere", (0, 0, 0), 5000), 0.0001,
                           (1.0, 1.0, 1.0))
    earth = sb.image_texture(_image_source("earthmap.jpg"))
    sb.add_sphere((400, 200, 400), 100, sb.lambertian(earth))
    sb.add_sphere((220, 280, 300), 80, sb.lambertian((0.5, 0.5, 0.5)))
    # 1,000 spheres in a 165 cube, rotated 15 degrees about y (x' = x cos
    # + z sin, z' = z cos - x sin) and moved by (-100, 270, 395)
    white = sb.lambertian((0.73, 0.73, 0.73))
    cos15, sin15 = np.cos(np.radians(15.0)), np.sin(np.radians(15.0))
    for _ in range(1000):
        x, y, z = map(float, rng.vec_t(0.0, 165.0))
        c = (cos15 * x + sin15 * z - 100.0, y + 270.0,
             cos15 * z - sin15 * x + 395.0)
        sb.add_sphere(tuple(float(np.float32(v)) for v in c), 10, white)
    cam = _camera((478, 278, -600), (278, 278, 0), 40.0, 1.0, 0.0,
                  t0=0.0, t1=1.0)
    return sb, cam


def _build_next_week_final(device: Device = "cuda") -> Tuple[Scene, Camera]:
    sb, cam = next_week_final_builder()
    return sb.build(device=device), cam


NEXT_WEEK_FINAL = Preset("next_week_final", 800, 800, 10000, 40,
                         _build_next_week_final)

PRESETS = {p.name: p for p in [THREE_SPHERES, RTIOW_COVER, CORNELL_BOX,
                               TEXTURED_MOTION, FINAL_SCENE,
                               NEXT_WEEK_FINAL]}
