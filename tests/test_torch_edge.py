"""The oracle's gradients against the reference package's, on the CPU.

* `trace(differentiable=True)` on tests/test_grad.py's scene (12x12,
  4 spp, depth 4, attenuated emission): the gradients of the mean
  radiance w.r.t. the ball's albedo and the light's emission are within
  1e-4 relative of `jax.grad` of the reference's, and within 2e-2 of a
  central finite difference of the port's own render (the tolerance
  tests/test_grad.py holds the reference to).
* `diff.edge.sphere_silhouette_grad` on tests/test_edge_grad.py's config
  (one lambertian sphere over the sky, 40x40, pinhole, n_edge 192,
  spp_edge 48, depth 4, seed 5): the centre and radius terms within
  1e-4 relative of the reference's (the same streams on both sides; the
  projection's 3x3 solve is LAPACK's here and XLA's there).

Every reference call is made once, in the module's fixture (one
`jax.grad` for both parameters).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.core import rng as JR
from path_tracer_tpu.core.camera import Camera as JCamera
from path_tracer_tpu.diff.edge import sphere_silhouette_grad as jedge
from path_tracer_tpu.engine import integrator as JI
from path_tracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.core import rng as TR
from path_tracer_tpu_torch.diff.edge import sphere_silhouette_grad
from path_tracer_tpu_torch.engine import integrator as TI

DW = DH = 12                     # test_grad's setting
DSPP, DDEPTH = 4, 4
ALBEDO_ROW, LIGHT_ROW = 1, 2     # the ball's and the light's texture rows
EW = EH = 40                     # test_edge_grad's setting
EDGE_KW = dict(n_edge=192, spp_edge=48, max_depth=4, seed=5)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _grad_scene():
    """tests/test_grad.py's scene: ground, a lambertian ball, a light."""
    sb = JSceneBuilder()
    sb.add_sphere((0, -100.5, -1), 100.0, sb.lambertian((0.6, 0.6, 0.6)))
    sb.add_sphere((0, 0, -1), 0.5, sb.lambertian((0.5, 0.2, 0.3)))
    sb.add_sphere((0, 1.2, -1), 0.3, sb.light((4.0, 4.0, 4.0)))
    return sb.build(), JCamera.create((0, 0.2, 0.6), (0, 0, -1), (0, 1, 0),
                                      60.0, 1.0, 0.0, 1.6)


def _edge_scene():
    """tests/test_edge_grad.py's scene and pinhole camera."""
    sb = JSceneBuilder()
    sb.add_sphere((0.0, 0.0, -1.0), 0.5, sb.lambertian((0.2, 0.3, 0.6)))
    return sb.build(), JCamera.create((0, 0, 1), (0, 0, -1), (0, 1, 0),
                                      60.0, 1.0, 0.0, 2.0)


def _with_c1(scene, xp, albedo, light):
    """The scene with the ball's albedo red and the light's three
    channels set (xp: the array module's functional row update)."""
    c1 = scene.textures.c1
    c1 = type(c1)(xp(xp(c1.x, ALBEDO_ROW, albedo), LIGHT_ROW, light),
                  xp(c1.y, LIGHT_ROW, light), xp(c1.z, LIGHT_ROW, light))
    return scene._replace(textures=scene.textures._replace(c1=c1))


def _jax_set(a, i, v):
    return a.at[i].set(v)


def _torch_set(a, i, v):
    return torch.cat([a[:i], v.reshape(1), a[i + 1:]])


def _jax_loss(scene, cam, albedo, light):
    n = DW * DH
    pix = jnp.tile(jnp.arange(n, dtype=jnp.uint32), DSPP)
    samp = jnp.repeat(jnp.arange(DSPP, dtype=jnp.uint32), n)
    state, o, d, t = JI.camera_rays(cam, DW, DH, pix,
                                    JR.seed_perf(pix, samp, 0))
    _, rad = JI.trace(_with_c1(scene, _jax_set, albedo, light), o, d, t,
                      state, DDEPTH, attenuate_emission=True,
                      differentiable=True)
    return (jnp.mean(rad.x) + jnp.mean(rad.y) + jnp.mean(rad.z)) / 3.0


def _port_loss(scene, cam, albedo, light):
    n = DW * DH
    pix = torch.arange(n).repeat(DSPP)
    samp = torch.arange(DSPP).repeat_interleave(n)
    state, o, d, t = TI.camera_rays(cam, DW, DH, pix,
                                    TR.seed_perf(pix, samp, 0))
    _, rad = TI.trace(_with_c1(scene, _torch_set, albedo, light), o, d, t,
                      state, DDEPTH, attenuate_emission=True,
                      differentiable=True)
    return (rad.x.mean() + rad.y.mean() + rad.z.mean()) / 3.0


@pytest.fixture(scope="module")
def refs():
    gs, gc = _grad_scene()
    g_alb, g_light = jax.grad(lambda a, v: _jax_loss(gs, gc, a, v),
                              argnums=(0, 1))(jnp.float32(0.5),
                                              jnp.float32(4.0))
    es, ec = _edge_scene()
    ct = jnp.full((EH, EW, 3), 1.0 / (EW * EH * 3), jnp.float32)
    eg = jedge(es, ec, EW, EH, 0, ct, **EDGE_KW)
    return dict(grad=(gs, gc, float(g_alb), float(g_light)),
                edge=(es, ec, [float(c) for c in eg.center],
                      float(eg.radius)))


@pytest.mark.parametrize("what", ["albedo", "light"])
def test_trace_gradients_match_jax_grad_and_fd(refs, what):
    gs, gc, g_alb, g_light = refs["grad"]
    scene = scene_from_numpy(_np_tree(gs), "cpu")
    cam = camera_from_numpy(_np_tree(gc))
    x0 = {"albedo": 0.5, "light": 4.0}
    x = {k: torch.tensor(v, requires_grad=(k == what))
         for k, v in x0.items()}
    (g,) = torch.autograd.grad(_port_loss(scene, cam, x["albedo"],
                                          x["light"]), x[what])
    eps = 1e-2

    def at(v):
        kw = {k: torch.tensor(v if k == what else x0[k]) for k in x0}
        with torch.no_grad():
            return float(_port_loss(scene, cam, kw["albedo"], kw["light"]))

    fd = (at(x0[what] + eps) - at(x0[what] - eps)) / (2 * eps)
    want = g_alb if what == "albedo" else g_light
    assert np.isfinite(float(g)) and float(g) > 0
    np.testing.assert_allclose(float(g), want, rtol=1e-4)
    np.testing.assert_allclose(float(g), fd, rtol=2e-2)


def test_silhouette_grad_matches_the_reference(refs):
    es, ec, center, radius = refs["edge"]
    scene = scene_from_numpy(_np_tree(es), "cpu")
    cam = camera_from_numpy(_np_tree(ec))
    ct = torch.full((EH, EW, 3), 1.0 / (EW * EH * 3))
    eg = sphere_silhouette_grad(scene, cam, EW, EH, 0, ct, **EDGE_KW)
    got = [float(c) for c in eg.center] + [float(eg.radius)]
    want = center + [radius]
    assert all(np.isfinite(got))
    # the radius term is the large one (the silhouette grows outward);
    # the centre's x and y cancel around the circle
    scale = max(abs(v) for v in want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    assert abs(want[3]) == scale
