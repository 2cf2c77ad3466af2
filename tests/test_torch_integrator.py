"""The port's oracle integrator (`engine.integrator`) against the reference
package's and against the NumPy oracle (tests/oracle.py), on the CPU.

* One bounce at a time: on cornell_box's camera rays (16x16, 4 spp) the
  port's `_bounce` equals the reference's, run op by op (not jitted), bit
  for bit on every state plane through 6 bounces: rects, boxes, an
  emitter and lambertian scatter, no transcendental that XLA and libm
  round apart.
* `render_parity` on tests/test_golden.py's full-feature scene (16x12,
  3 spp, depth 8) against the reference's `render_parity` and the oracle,
  each inside test_golden.py's `_robust_compare` (>= 93% of pixels within
  2e-3, mean error <= 4e-3): the jitted reference contracts a*b+c into
  FMA and rounds XLA's float32 sin, cos, atan2 and log, the oracle is
  NumPy, and a one-rounding difference flips a knife-edge path.  Banding
  is bit-exact.
* `trace(differentiable=True)` renders what the loop does (its gradients
  are held in tests/test_torch_edge.py).

Every reference call is made once, in the module's fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from path_tracer_tpu.core import rng as JR
from path_tracer_tpu.core.camera import Camera as JCamera
from path_tracer_tpu.core.vec import Vec3 as JVec3
from path_tracer_tpu.engine import integrator as JI
from path_tracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from path_tracer_tpu.scene.presets import CORNELL_BOX
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.core import rng as TR
from path_tracer_tpu_torch.core.vec import Vec3
from path_tracer_tpu_torch.engine import integrator as TI

GW, GH, GSPP, GDEPTH = 16, 12, 3, 8           # test_golden's full features


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _full_feature_scene():
    """tests/test_golden.py's full-feature scene."""
    sb = JSceneBuilder()
    checker = sb.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    sb.add_sphere((0, -100.5, -1), 100.0, sb.lambertian(checker))
    sb.add_sphere((0, 0, -1.2), 0.5, sb.lambertian((0.1, 0.2, 0.5)))
    sb.add_sphere((-1.05, 0, -1.2), 0.5, sb.dielectric(1.5, (1.0, 0.9, 0.9)))
    sb.add_sphere((1.05, 0, -1.2), 0.5, sb.metal((0.8, 0.6, 0.2), 0.15))
    sb.add_moving_sphere((0, 0.9, -1.2), (0, 1.1, -1.2), 0.0, 1.0, 0.2,
                         sb.lambertian((0.9, 0.3, 0.3)))
    sb.add_xy_rect(-0.5, 0.5, 0.1, 0.7, -2.2, sb.light((4, 4, 4)))
    sb.add_triangle((-2, 0, -2), (-1.2, 0, -2), (-1.6, 0.9, -2),
                    sb.lambertian((0.3, 0.8, 0.3)))
    sb.add_box((0.6, -0.5, -2.0), (1.0, 0.1, -1.7),
               sb.metal((0.7, 0.6, 0.5), 0.3))
    sb.add_constant_medium(("sphere", (-0.3, 0.2, -0.7), 0.25), 3.0,
                           (1, 1, 1))
    img = np.zeros((4, 4, 3), np.uint8)
    img[::2, ::2] = [255, 0, 0]
    img[1::2, 1::2] = [0, 0, 255]
    tex = sb.image_texture(img)
    sb.add_sphere((0.55, 0.55, -1.0), 0.18, sb.lambertian(tex))
    cam = JCamera.create((0, 0.4, 1.2), (0, 0, -1), (0, 1, 0), 55.0,
                         1.5, 0.04, 2.2, 0.0, 1.0)
    return sb.build(), cam


def _jax_bounces(scene, cam, w, h, spp, depth):
    n = w * h * spp
    pix = jnp.tile(jnp.arange(w * h, dtype=jnp.uint32), spp)
    samp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), w * h)
    state = JR.seed_perf(pix, samp, 0)
    state, o, d, t = JI.camera_rays(cam, w, h, pix, state)
    one, zero = jnp.ones(n), jnp.zeros(n)
    st = JI.PathState(o, d, t, state, JVec3(one, one, one),
                      JVec3(zero, zero, zero), jnp.ones(n, bool))
    states = []
    for _ in range(depth):
        st = JI._bounce(scene, st, False, 1e-3, True)
        states.append(jax.tree_util.tree_map(np.asarray, st))
    return states


@pytest.fixture(scope="module")
def refs():
    fs, fc = _full_feature_scene()
    cs, cc = CORNELL_BOX.build()
    return dict(
        full=(fs, fc),
        parity=np.asarray(JI.render_parity(fs, fc, GW, GH, GSPP, GDEPTH)),
        oracle=oracle.render(fs, fc, GW, GH, GSPP, GDEPTH),
        cornell=(cs, cc, _jax_bounces(cs, cc, 16, 16, 4, 6)))


def _robust_compare(got, want, frac, pixel_tol, mean_tol):
    """tests/test_golden.py's comparison."""
    got = np.asarray(got, np.float32)
    diff = np.abs(got - want).max(axis=-1)
    close = (diff <= pixel_tol).mean()
    mae = np.abs(got - want).mean()
    assert close >= frac, f"only {close:.3f} of pixels within {pixel_tol}"
    assert mae <= mean_tol, f"mean abs err {mae}"


def test_bounces_bit_equal_to_the_reference_ops(refs):
    cs, cc, want = refs["cornell"]
    scene = scene_from_numpy(_np_tree(cs), "cpu")
    cam = camera_from_numpy(_np_tree(cc))
    w = h = 16
    spp = 4
    pix = torch.arange(w * h).repeat(spp)
    samp = torch.arange(spp).repeat_interleave(w * h)
    state, o, d, t = TI.camera_rays(cam, w, h, pix,
                                    TR.seed_perf(pix, samp, 0))
    one, zero = torch.ones(pix.shape[0]), torch.zeros(pix.shape[0])
    st = TI.PathState(o, d, t, state, Vec3(one, one, one),
                      Vec3(zero, zero, zero), torch.ones_like(one).bool())
    for b, ref in enumerate(want):
        st = TI._bounce(scene, st, False, 1e-3, True)
        for name in ("o", "d", "throughput", "radiance"):
            for i in range(3):
                np.testing.assert_array_equal(
                    getattr(st, name)[i].numpy(), getattr(ref, name)[i],
                    err_msg=f"bounce {b} {name}[{i}]")
        np.testing.assert_array_equal(st.rng.numpy(),
                                      ref.rng.astype(np.int64))
        np.testing.assert_array_equal(st.alive.numpy(), ref.alive)
    assert not st.alive.all()          # paths ended along the way


def _port_parity(refs, **kw):
    fs, fc = refs["full"]
    return TI.render_parity(scene_from_numpy(_np_tree(fs), "cpu"),
                            camera_from_numpy(_np_tree(fc)), GW, GH, GSPP,
                            GDEPTH, device="cpu", **kw).numpy()


@pytest.fixture(scope="module")
def parity(refs):
    return _port_parity(refs)


def test_render_parity_matches_the_reference(refs, parity):
    assert parity.shape == (GH, GW, 3) and np.isfinite(parity).all()
    _robust_compare(parity, refs["parity"], frac=0.93, pixel_tol=2e-3,
                    mean_tol=4e-3)


def test_render_parity_matches_the_oracle(refs, parity):
    _robust_compare(parity, refs["oracle"], frac=0.93, pixel_tol=2e-3,
                    mean_tol=4e-3)


@pytest.mark.parametrize("band_rows", [1, 5])
def test_render_parity_banding_is_bit_exact(refs, parity, band_rows):
    np.testing.assert_array_equal(_port_parity(refs, band_rows=band_rows),
                                  parity)


def test_differentiable_trace_renders_what_the_loop_does(refs):
    cs, cc, _ = refs["cornell"]
    scene = scene_from_numpy(_np_tree(cs), "cpu")
    cam = camera_from_numpy(_np_tree(cc))
    pix = torch.arange(64).repeat(2)
    samp = torch.arange(2).repeat_interleave(64)
    state, o, d, t = TI.camera_rays(cam, 8, 8, pix,
                                    TR.seed_perf(pix, samp, 0))
    _, a = TI.trace(scene, o, d, t, state, 4, differentiable=True)
    _, b = TI.trace(scene, o, d, t, state, 4, differentiable=False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.detach().numpy(), y.numpy())
