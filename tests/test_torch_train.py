"""The port's one-device training step (`parallel.mesh.make_train_step`)
against the reference's `make_train_step` on a 1x1 mesh, on the CPU.

Setup of tests/test_sharding.py:60-96: the three-sphere scene at 16x8,
depth 3, 2 spp a step, the material colours' x perturbed by +0.2, SGD at
lr 0.5 on the material colours only (`grad_filter`).  Both steps take the
same target (the port's work-queue render at 4 spp, as numpy) and the
same params (carried across with `convert`); the reference runs with its
FETCH_MODE "high" (exact f32 fetch) inside the fixture only.
Tolerances: the loss within 1e-4 relative (the recordings' knife-edge
lanes and the sum order), every updated param within 1e-6 of the
reference's, and the update p' - p within 2e-2 relative L2 of the
reference's update.  On the port alone, the loss falls over 3 steps, and
backend="pallas" (the reference's name for the route) takes the same step
as the default backend="queued".
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.diff import queued_vjp as JQ
from path_tracer_tpu.parallel import mesh as JM
from path_tracer_tpu.scene.presets import THREE_SPHERES
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.diff import params as TP
from path_tracer_tpu_torch.engine.wq import render_wq
from path_tracer_tpu_torch.parallel import mesh as TM

W, H, DEPTH, LOCAL_SPP, LR = 16, 8, 3, 2, 0.5


def _perturb(params, add):
    scene_p, cam_p = params
    c = scene_p.materials.color
    return (scene_p._replace(materials=scene_p.materials._replace(
        color=type(c)(c.x + add, c.y, c.z))), cam_p)


def _only_material_colors(zeros_like):
    def f(grads):
        scene_g, cam_g = grads
        zs, zc = TP.tree_map(lambda g: None if g is None else zeros_like(g),
                             grads)
        return (zs._replace(materials=zs.materials._replace(
            color=scene_g.materials.color)), zc)
    return f


def _port_tree(jtree):
    jtree = jax.tree_util.tree_map(np.asarray, jtree)
    return (scene_from_numpy(jtree[0], "cpu"), camera_from_numpy(jtree[1]))


@pytest.fixture(scope="module")
def steps():
    js, jc = THREE_SPHERES.build()
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    cam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jc))
    target = render_wq(scene, cam, W, H, 4, max_depth=DEPTH,
                       device="cpu").reshape(W * H, 3)

    jparams, (js_s, jc_s) = JM.scene_camera_params(js, jc)
    jparams = _perturb(jparams, 0.2)
    mesh = JM.make_mesh(n_tiles=1, n_spp=1, devices=jax.devices()[:1])

    def jfilter(grads):
        zeros = jax.tree_util.tree_map(
            lambda g: jnp.zeros_like(g) if g is not None else None, grads,
            is_leaf=lambda x: x is None)
        zs, zc = zeros
        return (zs._replace(materials=zs.materials._replace(
            color=grads[0].materials.color)), zc)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JQ, "FETCH_MODE", "high")
        jstep = JM.make_train_step(js_s, jc_s, W, H, LOCAL_SPP, DEPTH, mesh,
                                   lr=LR, grad_filter=jfilter)
        jnew, jloss = jstep(jparams, jnp.asarray(target.numpy()),
                            jnp.arange(W * H, dtype=jnp.uint32))

    params, (s_scene, s_cam) = TM.scene_camera_params(scene, cam)
    params = _perturb(params, 0.2)
    step = TM.make_train_step(s_scene, s_cam, W, H, LOCAL_SPP, DEPTH, lr=LR,
                              grad_filter=_only_material_colors(
                                  torch.zeros_like), device="cpu")
    pix = torch.arange(W * H)
    new, loss = step(params, target, pix)
    losses = [float(loss)]
    p = new
    for _ in range(2):
        p, l2 = step(p, target, pix)
        losses.append(float(l2))
    return dict(params=params, new=new, loss=float(loss),
                jnew=_port_tree(jnew), jloss=float(jloss), losses=losses,
                static=(s_scene, s_cam), target=target)


def test_loss_matches_reference(steps):
    assert np.isfinite(steps["loss"]) and steps["loss"] > 0
    assert abs(steps["loss"] - steps["jloss"]) <= 1e-4 * steps["jloss"], (
        steps["loss"], steps["jloss"])


def test_updated_params_match_reference(steps):
    old = TP.leaves(steps["params"])
    new = TP.leaves(steps["new"])
    ref = TP.leaves(steps["jnew"])
    assert len(old) == len(new) == len(ref)
    moved = 0
    for o, n, r in zip(old, new, ref):
        np.testing.assert_allclose(n.numpy(), r.numpy(), rtol=0, atol=1e-6)
        du, dr = (n - o).double(), (r - o).double()
        assert float((du - dr).norm()) <= 2e-2 * float(dr.norm()) + 1e-9
        moved += float(dr.norm()) > 0
    assert moved == 3          # only the material colours move


def test_loss_falls_over_three_steps(steps):
    losses = steps["losses"]
    assert all(np.isfinite(losses)), losses
    assert losses[0] > losses[1] > losses[2], losses



def test_pallas_backend_is_the_queued_route(steps):
    step = TM.make_train_step(*steps["static"], W, H, LOCAL_SPP, DEPTH,
                              lr=LR, grad_filter=_only_material_colors(
                                  torch.zeros_like), device="cpu",
                              backend="pallas")
    new, loss = step(steps["params"], steps["target"], torch.arange(W * H))
    assert float(loss) == steps["loss"]
    for a, b in zip(TP.leaves(new), TP.leaves(steps["new"])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_unknown_backend_names_every_backend(steps):
    with pytest.raises(ValueError, match="'queued', 'pallas'.*'jnp'"):
        TM.make_train_step(*steps["static"], W, H, LOCAL_SPP, DEPTH,
                           device="cpu", backend="mxu")
