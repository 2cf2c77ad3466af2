"""A throwaway benchmark made of new files alone: a tiny scene, two
traffic mixes (frames and a preview) and their limits, beside the real
kinds and metric readers.  The CPU tests run it with the kernel's
plain version; nothing here asks for a card."""
from __future__ import annotations

import json
import os
from pathlib import Path

import pytest

REAL = Path(__file__).resolve().parent.parent

TINY = '''"""A tiny scene for the harness's CPU tests."""
NAME = "tiny"
SOURCE = "port_bench/tests"
CONFIG = {"resolution": [16, 12], "spp": 2, "max_depth": 6,
          "camera": {"look_from": [0.0, 0.6, 2.0], "look_at": [0.0, 0.2, -1.0],
                     "vup": [0.0, 1.0, 0.0], "vfov": 50.0, "aperture": 0.02,
                     "focus": None, "time0": 0.0, "time1": 1.0},
          "reduced": {}, "assumed": {}}
CALLS = [
    ["checker_texture", [0.2, 0.3, 0.1], [0.9, 0.9, 0.9]],
    ["lambertian", {"ref": 0, "kind": "tex"}],
    ["add_sphere", [0.0, -100.5, -1.0], 100.0, {"ref": 0, "kind": "mat"}],
    ["metal", [0.8, 0.6, 0.2], 0.3],
    ["add_sphere", [0.7, 0.0, -1.0], 0.5, {"ref": 1, "kind": "mat"}],
    ["dielectric", 1.5, [1.0, 0.8, 0.8]],
    ["add_moving_sphere", [-0.7, 0.0, -1.0], [-0.7, 0.2, -1.0], 0.0, 1.0, 0.45, {"ref": 2, "kind": "mat"}],
    ["light", [4.0, 4.0, 4.0]],
    ["add_xz_rect", -1.0, 1.0, -2.0, 0.0, 1.5, {"ref": 3, "kind": "mat"}],
    ["image_texture", {"image": "procedural_logo", "size": [8, 8]}],
    ["lambertian", {"ref": 2, "kind": "tex"}],
    ["add_triangle", [-1.5, -0.5, -2.0], [1.5, -0.5, -2.0], [0.0, 1.0, -2.0], {"ref": 4, "kind": "mat"}],
    ["add_constant_medium", ["sphere", [0.0, 0.0, -0.5], 0.2], 1.0, [1.0, 1.0, 1.0]],
]

import numpy as np


def image(spec):
    w, h = spec["size"]
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 30, yy * 30, (xx + yy) % 2 * 255],
                    -1).astype(np.uint8)
'''

TRAFFIC = {
    "frames": {"kind": "frames", "spp": 2, "progressive": False,
               "check_pixels": 64, "trace_units": 2},
    "preview": {"kind": "frames", "spp": 1, "progressive": True,
                "check_pixels": 64, "trace_units": 2},
}
LIMITS = {"frames": {"img_gap": 1e-4, "segs_gap": 0.5},
          "preview": {"img_gap": 1e-4, "segs_gap": 0.5}}


def make_tiny(tmp: Path) -> Path:
    """Writes the throwaway benchmark under `tmp`; returns its
    BENCHMARK.json (its files under `tmp/pb`)."""
    root = tmp / "pb"
    for d in ("configs", "traffic", "limits"):
        (root / d).mkdir(parents=True)
    for d in ("kinds", "metrics"):
        os.symlink(REAL / d, root / d)
    (root / "configs" / "tiny.py").write_text(TINY)
    b = json.loads((REAL.parent / "BENCHMARK.json").read_text())
    b["configs"] = [{"name": "tiny", "source": "port_bench/tests",
                     "file": "pb/configs/tiny.py", "reduced": [],
                     "why": "a throwaway scene"}]
    b["workloads"] = []
    for t, tr in TRAFFIC.items():
        (root / "traffic" / f"tiny_{t}.json").write_text(json.dumps(tr))
        name = f"tiny.{t}"
        (root / "limits" / f"{name}.json").write_text(json.dumps(LIMITS[t]))
        b["workloads"].append({"name": name, "config": "tiny",
                               "traffic": f"tiny_{t}", "chips": 1,
                               "why": "a throwaway cell"})
    for m in b["end_to_end"] + b["per_layer"]:
        m.pop("workloads", None)
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(b))
    return path


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    path = make_tiny(tmp_path_factory.mktemp("bench"))
    return path, path.parent / "pb"
