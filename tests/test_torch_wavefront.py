"""The port's perf-mode oracle renderers against the reference's, and the
port's work queue anchored to the port's oracle, on the CPU.

tests/test_wq.py's three anchor configs: three_spheres 32x16, cornell_box
16x16 (4 spp, depth 6) and the final scene 24x16 (4 spp, depth 8).

* The port's `render_wavefront`, `render_fused` and `render_perf` against
  the reference's `render_wavefront` on every config (all three consume
  the same per-(pixel, sample) streams), and against the reference's own
  `render_fused` and `render_perf` on the final scene, inside
  test_wq.py's final-scene envelope: at most 3% of pixels beyond 5e-3.
  Not its 2e-4 / 0% bound of the two small configs: the reference's
  renderers are jitted, and XLA's CPU jit contracts a*b+c into FMA, so a
  lane's rounding differs from the op-by-op float32 the port does (which
  equals the reference's un-jitted ops bit for bit,
  tests/test_torch_integrator.py); on cornell_box 4 of 256 pixels take
  another knife-edge path that way.
* The port's `render_wq` (the bounce kernel's plain version) against the
  port's `render_wavefront`, as tests/test_wq.py:24-36 anchors the
  reference's: within 2e-4 on every pixel on the two small configs, at
  most 3% beyond 5e-3 on the final scene.
* The wavefront's schedule: the CPU tiling (16,384 pixels, 4 lanes a
  pixel) and the card's (the frame in one tile, one lane a pixel).

Every reference call is made once, in the module's fixture.
"""
import jax
import numpy as np
import pytest
import torch

from path_tracer_tpu.engine import integrator as JI
from path_tracer_tpu.scene.presets import (CORNELL_BOX, THREE_SPHERES,
                                           build_final_scene)
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.engine import integrator as TI
from path_tracer_tpu_torch.engine.wq import render_wq

CONFIGS = {"three_spheres": (32, 16, 4, 6), "cornell_box": (16, 16, 4, 6),
           "final_scene": (24, 16, 4, 8)}
WQ_ENVELOPE = {"three_spheres": (2e-4, 0.0), "cornell_box": (2e-4, 0.0),
               "final_scene": (5e-3, 0.03)}


def _build(name):
    if name == "three_spheres":
        return THREE_SPHERES.build()
    if name == "cornell_box":
        return CORNELL_BOX.build()
    return build_final_scene(1.5)


@pytest.fixture(scope="module")
def refs():
    out = {}
    for name, (w, h, spp, depth) in CONFIGS.items():
        js, jc = _build(name)
        r = {"wavefront": np.asarray(JI.render_wavefront(
            js, jc, w, h, spp, max_depth=depth))}
        if name == "final_scene":
            for fn in ("render_fused", "render_perf"):
                r[fn[7:]] = np.asarray(getattr(JI, fn)(
                    js, jc, w, h, spp, max_depth=depth))
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
        out[name] = (scene_from_numpy(np_tree(js), "cpu"),
                     camera_from_numpy(np_tree(jc)), r)
    return out


def _envelope(img, ref, tol, frac):
    assert img.shape == ref.shape and np.isfinite(img).all()
    d = np.abs(img - ref).max(axis=-1)
    assert float((d > tol).mean()) <= frac, (float((d > tol).mean()),
                                             float(d.max()))


@pytest.mark.parametrize("renderer", ["wavefront", "fused", "perf"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_oracle_renderers_match_the_reference(refs, name, renderer):
    scene, cam, r = refs[name]
    w, h, spp, depth = CONFIGS[name]
    img = getattr(TI, f"render_{renderer}")(scene, cam, w, h, spp,
                                           max_depth=depth,
                                           device="cpu").numpy()
    _envelope(img, r.get(renderer, r["wavefront"]), 5e-3, 0.03)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_render_wq_is_anchored_to_the_wavefront_oracle(refs, name):
    scene, cam, _ = refs[name]
    w, h, spp, depth = CONFIGS[name]
    ref = TI.render_wavefront(scene, cam, w, h, spp, max_depth=depth,
                              device="cpu").numpy()
    img = render_wq(scene, cam, w, h, spp, max_depth=depth, tile_rows=4,
                    window=3, device="cpu").numpy()
    _envelope(img, ref, *WQ_ENVELOPE[name])


def test_wavefront_stats_and_tiling(refs):
    scene, cam, _ = refs["cornell_box"]
    img, stats = TI.render_wavefront(scene, cam, 16, 16, 4, max_depth=6,
                                     return_stats=True, device="cpu")
    img2, segs = TI.render_wavefront(scene, cam, 16, 16, 4, max_depth=6,
                                     return_segments=True, device="cpu")
    np.testing.assert_array_equal(img.numpy(), img2.numpy())
    assert stats["segments"] == segs
    # 256 pixels in one tile, 4 lanes each; a lane's paths run back to back
    assert stats["lanes"] == 1024 and stats["tiles"] == 1
    assert 256 * 4 <= segs <= stats["iters"] * stats["lanes"]
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert TI.wavefront_tiling(800 * 600, 8, cpu) == (16384, 4)
    assert TI.wavefront_tiling(800 * 600, 8, cuda) == (480000, 1)
    assert TI.wavefront_tiling(1000 * 1000, 8, cuda) == (1 << 19, 1)
    assert TI.wavefront_tiling(16 * 16, 2, cpu) == (256, 2)
