"""The oracle engine on the multi-device layer, on the CPU:
`render_sharded(renderer="jnp")` and `make_train_step(backend="jnp",
geometry_edge=...)` against the reference's, on a 1x1 mesh.

* `render_sharded(renderer="jnp")` of three_spheres (16x8, 5 spp, depth
  3) against the reference's jnp renderer on a 1x1 mesh, inside
  test_wq.py's final-scene envelope (at most 3% of pixels beyond 5e-3:
  the jitted reference contracts a*b+c into FMA); on the 1x1 mesh it is
  the port's `render_perf` bit for bit, and the shards of a 2x1 and a 1x2
  grid (Mesh objects without a process group, so each rank's reduction
  is summed here by hand) add up to it within 1e-6.
* One `make_train_step(backend="jnp", geometry_edge=[1])` step on every
  float leaf (tests/test_torch_train.py's setup: 16x8, depth 3, 2 spp,
  the material colours +0.2, lr 0.5; the silhouette term of sphere 1 with
  n_edge 32, spp_edge 4): the loss within 1e-4 relative of the
  reference's, and each leaf's update within 2e-2 relative L2 of the
  reference's (knife-edge lanes, where the jitted reference's FMA takes
  another branch, and the order of the gradient sums); sphere 1's centre
  and radius updates carry the edge term (they differ from a step
  without it).

The reference is called once, in the module's fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.parallel import mesh as JM
from path_tracer_tpu.scene.presets import THREE_SPHERES
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.diff import params as TP
from path_tracer_tpu_torch.engine.integrator import render_perf
from path_tracer_tpu_torch.engine.wq import render_wq
from path_tracer_tpu_torch.parallel import mesh as TM
from tools.make_jax_goldens import perturb

W, H, DEPTH, LOCAL_SPP, LR = 16, 8, 3, 2, 0.5
RSPP = 5
EDGE = [1]
EDGE_KW = dict(n_edge=32, spp_edge=4, max_depth=DEPTH)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def run():
    js, jc = THREE_SPHERES.build()
    scene = scene_from_numpy(_np_tree(js), "cpu")
    cam = camera_from_numpy(_np_tree(jc))
    mesh = JM.make_mesh(n_tiles=1, n_spp=1, devices=jax.devices()[:1])
    jframe = np.asarray(JM.render_sharded(js, jc, W, H, RSPP, mesh,
                                          max_depth=DEPTH, renderer="jnp"))
    target = render_wq(scene, cam, W, H, 4, max_depth=DEPTH,
                       device="cpu").reshape(W * H, 3)
    jparams, (js_s, jc_s) = JM.scene_camera_params(js, jc)
    jstep = JM.make_train_step(js_s, jc_s, W, H, LOCAL_SPP, DEPTH, mesh,
                               lr=LR, backend="jnp", geometry_edge=EDGE,
                               edge_kwargs=EDGE_KW)
    jnew, jloss = jstep(perturb(jparams, 0.2), jnp.asarray(target.numpy()),
                        jnp.arange(W * H, dtype=jnp.uint32))
    jnew = jax.tree_util.tree_map(np.asarray, jnew)
    return dict(scene=scene, cam=cam, jframe=jframe, target=target,
                jnew=(scene_from_numpy(jnew[0], "cpu"),
                      camera_from_numpy(jnew[1])), jloss=float(jloss))


def _mesh(n_tiles, n_spp, tile, spp):
    return TM.Mesh(n_tiles, n_spp, tile, spp, torch.device("cpu"))


def test_render_sharded_jnp_matches_the_reference(run):
    fb = TM.render_sharded(run["scene"], run["cam"], W, H, RSPP,
                           TM.make_mesh(device="cpu"), max_depth=DEPTH,
                           renderer="jnp")
    img = fb.reshape(H, W, 3).numpy()
    d = np.abs(img - run["jframe"]).max(axis=-1)
    assert float((d > 5e-3).mean()) <= 0.03, float(d.max())
    perf = render_perf(run["scene"], run["cam"], W, H, RSPP,
                       max_depth=DEPTH, device="cpu").numpy()
    np.testing.assert_array_equal(img, perf)


def test_render_sharded_jnp_shards_add_up(run):
    perf = render_perf(run["scene"], run["cam"], W, H, RSPP,
                       max_depth=DEPTH, device="cpu").reshape(W * H, 3)
    kw = dict(max_depth=DEPTH, renderer="jnp")
    tiles = [TM.render_sharded(run["scene"], run["cam"], W, H, RSPP,
                               _mesh(2, 1, t, 0), **kw) for t in range(2)]
    np.testing.assert_allclose(torch.cat(tiles).numpy(), perf.numpy(),
                               rtol=0, atol=1e-6)
    # samples [0, 3) and [3, 5): the two ranks' sums before the all-reduce
    halves = [TM.render_sharded(run["scene"], run["cam"], W, H, RSPP,
                                _mesh(1, 2, 0, s), **kw) for s in range(2)]
    np.testing.assert_allclose((halves[0] + halves[1]).numpy(),
                               perf.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="return_stats"):
        TM.render_sharded(run["scene"], run["cam"], W, H, RSPP,
                          _mesh(1, 1, 0, 0), return_stats=True, **kw)


def _port_step(run, geometry_edge):
    params, (s_scene, s_cam) = TM.scene_camera_params(run["scene"],
                                                      run["cam"])
    params = perturb(params, 0.2)
    step = TM.make_train_step(s_scene, s_cam, W, H, LOCAL_SPP, DEPTH, lr=LR,
                              device="cpu", backend="jnp",
                              geometry_edge=geometry_edge,
                              edge_kwargs=EDGE_KW)
    new, loss = step(params, run["target"], torch.arange(W * H))
    return params, new, float(loss)


def test_jnp_train_step_with_edge_terms_matches_the_reference(run):
    params, new, loss = _port_step(run, EDGE)
    assert abs(loss - run["jloss"]) <= 1e-4 * run["jloss"], (loss,
                                                             run["jloss"])
    old, got, ref = (TP.leaves(t) for t in (params, new, run["jnew"]))
    assert len(old) == len(got) == len(ref)
    for o, n, r in zip(old, got, ref):
        du, dr = (n - o).double(), (r - o).double()
        assert float((du - dr).norm()) <= 2e-2 * float(dr.norm()) + 1e-7, (
            o.shape, float((du - dr).norm()), float(dr.norm()))
    # the edge term moved sphere 1's centre and radius
    _, plain, _ = _port_step(run, None)
    sph, sph0 = new[0].spheres, plain[0].spheres
    assert float(sph.radius[1]) != float(sph0.radius[1])
    assert float(sph.c0.x[1]) != float(sph0.c0.x[1])
    np.testing.assert_array_equal(sph.radius[2:].numpy(),
                                  sph0.radius[2:].numpy())
