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

The reference's values (one `jax.grad` for both parameters, and the
silhouette terms) are read from the golden
tests/golden/jax_ref/torch_edge.npz, which tools/make_jax_goldens.py
records from the frozen package at these inputs; the scenes are the
reference's, built there (`grad_scene`, `edge_scene`).
"""
import jax
import numpy as np
import pytest
import torch

from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.core import rng as TR
from path_tracer_tpu_torch.diff.edge import sphere_silhouette_grad
from path_tracer_tpu_torch.engine import integrator as TI
from tools import make_jax_goldens as golden

DW = DH = 12                     # test_grad's setting
DSPP, DDEPTH = 4, 4
ALBEDO_ROW, LIGHT_ROW = golden.ALBEDO_ROW, golden.LIGHT_ROW
EW = EH = 40                     # test_edge_grad's setting
EDGE_KW = dict(n_edge=192, spp_edge=48, max_depth=4, seed=5)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _set(a, i, v):
    return torch.cat([a[:i], v.reshape(1), a[i + 1:]])


def _with_c1(scene, albedo, light):
    """The scene with the ball's albedo red and the light's three
    channels set."""
    c1 = scene.textures.c1
    c1 = type(c1)(_set(_set(c1.x, ALBEDO_ROW, albedo), LIGHT_ROW, light),
                  _set(c1.y, LIGHT_ROW, light), _set(c1.z, LIGHT_ROW, light))
    return scene._replace(textures=scene.textures._replace(c1=c1))


def _port_loss(scene, cam, albedo, light):
    n = DW * DH
    pix = torch.arange(n).repeat(DSPP)
    samp = torch.arange(DSPP).repeat_interleave(n)
    state, o, d, t = TI.camera_rays(cam, DW, DH, pix,
                                    TR.seed_perf(pix, samp, 0))
    _, rad = TI.trace(_with_c1(scene, albedo, light), o, d, t,
                      state, DDEPTH, attenuate_emission=True,
                      differentiable=True)
    return (rad.x.mean() + rad.y.mean() + rad.z.mean()) / 3.0


@pytest.fixture(scope="module")
def refs():
    g = golden.load("torch_edge", dict(
        grad=dict(width=DW, height=DH, spp=DSPP, max_depth=DDEPTH,
                  albedo=0.5, light=4.0),
        edge=dict(width=EW, height=EH, **EDGE_KW)))
    return dict(grad=golden.grad_scene() + (float(g["g_albedo"]),
                                            float(g["g_light"])),
                edge=golden.edge_scene() + ([float(c) for c in g["center"]],
                                            float(g["radius"])))


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
