"""The Cornell box of Shirley's "Ray Tracing: The Next Week", frozen as data.

Source: "Ray Tracing: The Next Week", chapter "Cornell Box": five walls,
an area light and two boxes, a 600x600 frame at 200 samples a pixel,
depth 50, vfov 40, looking from (278, 278, -800) at (278, 278, 0).  The
scene is recorded from the program's `scene/presets.py:_build_cornell` as
the list of `SceneBuilder` calls it makes, in order.  Two departures
from the book, listed under `assumed`: the program's preset keeps the
two boxes axis-aligned (the chapter's first box placement) where the
book rotates and translates them, and a ray that leaves the box lights
its path with the program's blue-white sky where the book's background
is black.  A miss ends a path either way, so the paths and their
lengths, and with them the work, are the book's.
"""

NAME = "cornell_box"
SOURCE = ("https://raytracing.github.io/books/RayTracingTheNextWeek.html "
          "chapter Cornell Box")
CONFIG = {
    "resolution": [600, 600],
    "spp": 200,
    "max_depth": 50,
    "camera": {"look_from": [278.0, 278.0, -800.0], "look_at": [278.0, 278.0, 0.0], "vup": [0.0, 1.0, 0.0], "vfov": 40.0, "aperture": 0.0, "focus": None, "time0": 0.0, "time1": 0.0},
    "reduced": {},
    "assumed": {"boxes": "the two boxes are axis-aligned, as the "
                "program's preset builds them, where the book rotates "
                "them by 15 and -18 degrees about y",
                "background": "a ray that leaves through the open front "
                "takes the program's blue-white sky gradient, where the "
                "book's background is black; a miss ends the path "
                "either way, so path lengths are unchanged"},
}

CALLS = [
    ["lambertian", [0.65, 0.05, 0.05]],
    ["lambertian", [0.73, 0.73, 0.73]],
    ["lambertian", [0.12, 0.45, 0.15]],
    ["light", [15.0, 15.0, 15.0]],
    ["add_yz_rect", 0, 555, 0, 555, 555, {"ref": 2, "kind": "mat"}],
    ["add_yz_rect", 0, 555, 0, 555, 0, {"ref": 0, "kind": "mat"}],
    ["add_xz_rect", 213, 343, 227, 332, 554, {"ref": 3, "kind": "mat"}],
    ["add_xz_rect", 0, 555, 0, 555, 0, {"ref": 1, "kind": "mat"}],
    ["add_xz_rect", 0, 555, 0, 555, 555, {"ref": 1, "kind": "mat"}],
    ["add_xy_rect", 0, 555, 0, 555, 555, {"ref": 1, "kind": "mat"}],
    ["add_box", [130, 0, 65], [295, 165, 230], {"ref": 1, "kind": "mat"}],
    ["add_box", [265, 0, 295], [430, 330, 460], {"ref": 1, "kind": "mat"}],
]

