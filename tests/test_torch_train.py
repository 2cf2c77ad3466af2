"""The port's one-device training step (`parallel.mesh.make_train_step`)
against the reference's `make_train_step` on a 1x1 mesh, on the CPU.

Setup of tests/test_sharding.py:60-96: the three-sphere scene at 16x8,
depth 3, 2 spp a step, the material colours' x perturbed by +0.2, SGD at
lr 0.5 on the material colours only (`grad_filter`).  Both steps take the
same target (the reference's work-queue render at 4 spp) and the same
params (carried across with `convert`); the reference runs with its
FETCH_MODE "high" (exact f32 fetch).  The reference's step and target are
read from the golden tests/golden/jax_ref/torch_train.npz, which
tools/make_jax_goldens.py records from the frozen package at these
inputs.
Tolerances: the loss within 1e-4 relative (the recordings' knife-edge
lanes and the sum order), every updated param within 1e-6 of the
reference's, and the update p' - p within 2e-2 relative L2 of the
reference's update.  On the port alone, the loss falls over 3 steps, and
backend="pallas" (the reference's name for the route) takes the same step
as the default backend="queued".
"""
import jax
import numpy as np
import pytest
import torch

from path_tracer_tpu.parallel import mesh as JM
from path_tracer_tpu.scene.presets import THREE_SPHERES
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.diff import params as TP
from path_tracer_tpu_torch.parallel import mesh as TM
from tools import make_jax_goldens as golden

W, H, DEPTH, LOCAL_SPP, LR = 16, 8, 3, 2, 0.5


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


def step_golden(name, mesh):
    """The reference's first step on `mesh` (its target, updated params
    and loss), from the golden `name`."""
    g = golden.load(name, dict(
        scene="three_spheres", width=W, height=H, max_depth=DEPTH,
        local_spp=LOCAL_SPP, lr=LR, perturb_color_x=0.2, target_spp=4,
        fetch_mode="high", mesh=list(mesh)))
    js, jc = THREE_SPHERES.build()
    like = JM.scene_camera_params(js, jc)[0]
    return g["target"], _port_tree(golden.unflatten(g, "new", like)), float(
        g["loss"])


@pytest.fixture(scope="module")
def steps():
    js, jc = THREE_SPHERES.build()
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    cam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jc))
    target, jnew, jloss = step_golden("torch_train", (1, 1))
    target = torch.from_numpy(target)

    params, (s_scene, s_cam) = TM.scene_camera_params(scene, cam)
    params = golden.perturb(params, 0.2)
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
    return dict(params=params, new=new, loss=float(loss), jnew=jnew,
                jloss=jloss, losses=losses, static=(s_scene, s_cam),
                target=target)


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
