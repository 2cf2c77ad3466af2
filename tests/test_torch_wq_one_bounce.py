"""The port's one-bounce work-queue driver (`render_wq(window=1)`,
`engine.wq.render_wq_one_bounce`) against the reference's
`_render_wq_jit`, on the CPU, and the contracts tests/test_wq.py holds it
to.

Against the reference (one module-scoped fixture): the final scene at
16x16, 2 spp, depth 6, tile_rows=4 (tests/test_wq.py:97-113's config),
the reference's kernel in interpret mode, the port's plain version.  The
same bounce iterations and lane-steps (the loop runs until the queue is
drained and no lane is alive, so a knife-edge path that changes length
by a bounce could move it; none does here), segments within 0.2% and the
frame inside the final-scene envelope (at most 3% of pixels beyond
5e-3): knife-edge lanes flip a discrete branch after a one-rounding
difference (docs/PERF_NOTES.md:67-75).

On the port alone, tests/test_wq.py's contracts at window=1: the
`_anchor` configs against the port's `render_wavefront` (2e-4, no
outliers), the windowed driver's segments against the one-bounce
driver's, the drain-stage check, and `render_wq_range(window=1)`, which
the reference sends to the windowed driver at a one-bounce window.
"""
import jax
import numpy as np
import pytest
import torch

from path_tracer_tpu.engine import wq as JWQ
from path_tracer_tpu.scene.presets import build_final_scene
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.engine import wq as TWQ
from path_tracer_tpu_torch.engine.integrator import render_wavefront
from path_tracer_tpu_torch.scene import presets as TP


def _envelope(img, ref, tol, frac):
    assert img.shape == ref.shape and np.isfinite(img).all()
    d = np.abs(img - ref).max(axis=-1)
    assert float((d > tol).mean()) <= frac, (float((d > tol).mean()),
                                              float(d.max()))


@pytest.fixture(scope="module")
def final_16x16():
    js, jc = build_final_scene(1.5)
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    cam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jc))
    ref = JWQ.render_wq(js, jc, 16, 16, 2, max_depth=6, tile_rows=4,
                        window=1, return_stats=True)
    port = TWQ.render_wq(scene, cam, 16, 16, 2, max_depth=6, tile_rows=4,
                         window=1, return_stats=True, device="cpu")
    return dict(scene=scene, cam=cam,
                ref=(np.asarray(ref[0]), float(ref[1]), int(ref[2]),
                     float(ref[3])),
                port=(port[0].numpy(), port[1], port[2], port[3]))


def test_one_bounce_matches_reference(final_16x16):
    (rimg, rsegs, riters, rlanes) = final_16x16["ref"]
    (img, segs, iters, lanes) = final_16x16["port"]
    assert iters == riters and lanes == rlanes == iters * 512.0
    assert segs > 0 and abs(segs - rsegs) <= 0.002 * rsegs, (segs, rsegs)
    _envelope(img, rimg, 5e-3, 0.03)


def test_windowed_segments_match_one_bounce(final_16x16):
    """tests/test_wq.py:97-113: both drivers trace the same (pixel,
    sample) work, so their segment counts agree within the knife-edge
    envelope."""
    _, segsw, _, _ = TWQ.render_wq(final_16x16["scene"], final_16x16["cam"],
                                   16, 16, 2, max_depth=6, tile_rows=4,
                                   window=4, return_stats=True, device="cpu")
    segs1 = final_16x16["port"][1]
    assert abs(segs1 - segsw) <= 0.002 * segs1, (segs1, segsw)


@pytest.mark.parametrize("name,w,h", [("three_spheres", 32, 16),
                                      ("cornell_box", 16, 16)])
def test_one_bounce_anchored_to_wavefront(name, w, h):
    """tests/test_wq.py's `_anchor` at window=1: the same per-(pixel,
    sample) streams as the oracle engine, so the frames agree to float
    reassociation (cornell_box: unattenuated emission through the
    driver's deposit)."""
    scene, cam = TP.PRESETS[name].build(device="cpu")
    ref = render_wavefront(scene, cam, w, h, 4, max_depth=6,
                           device="cpu").numpy()
    img = TWQ.render_wq(scene, cam, w, h, 4, max_depth=6, tile_rows=4,
                        window=1, device="cpu").numpy()
    _envelope(img, ref, 2e-4, 0.0)


def test_drain_stage_compaction_matches_one_bounce():
    """tests/test_wq.py:69-95: at 48x32 (tile_rows=8: 2048 lanes, two
    tiles) the windowed driver compacts into a one-tile drain stage; it
    must agree with the one-bounce driver, which never compacts, and its
    lane-steps show the narrowed grid."""
    scene, cam = TP.build_final_scene(1.5, device="cpu")
    kw = dict(max_depth=6, tile_rows=8, return_stats=True, device="cpu")
    ref, segs1, _, _ = TWQ.render_wq(scene, cam, 48, 32, 1, window=1, **kw)
    img, segsw, iters_w, lsw = TWQ.render_wq(scene, cam, 48, 32, 1,
                                             window=2, **kw)
    _envelope(img.numpy(), ref.numpy(), 5e-3, 0.03)
    assert abs(segs1 - segsw) <= 0.002 * segs1
    assert lsw < iters_w * 2048.0


def test_render_wq_range_at_window_one():
    """As the reference does, `render_wq_range(window=1)` runs the windowed
    driver with a one-bounce window (bit-equal to `wq_window_fb` at
    window=1); its sums agree with the one-bounce driver's frame."""
    scene, cam = TP.build_final_scene(1.5, device="cpu")
    kw = dict(max_depth=4, tile_rows=8, device="cpu")
    fb = TWQ.render_wq_range(scene, cam, 8, 8, 0, 4, window=1, **kw)
    fb_w, _, _, _ = TWQ.wq_window_fb(
        scene, cam, 8, 8, n_pix_loc=64, spp_loc=4, chunk=4, window=1,
        max_depth=4, attenuate=False, t_min=1e-3, tile_rows=8, seed=0,
        device=torch.device("cpu"))
    np.testing.assert_array_equal(fb.numpy(), fb_w.numpy())
    img = TWQ.render_wq(scene, cam, 8, 8, 4, window=1, **kw)
    np.testing.assert_allclose((fb / 4.0).reshape(8, 8, 3).numpy(),
                               img.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="window"):
        TWQ.render_wq_range(scene, cam, 8, 8, 0, 4, window=0, **kw)
