"""The sharded render and train step on two gloo ranks on the CPU.

Two processes (`parallel.launch.spawn`) form a (tiles, spp) mesh: (2x1)
here, (1x2) in test_torch_sharded_spp.py (a file each, so that each
holds one reference train step).  On it:
- `render_sharded` of the three-sphere scene at 16x8, 4 spp, depth 3,
  put together by `assemble_image`, against the port's `render_wq` in one
  process: rtol 1e-5, atol 1e-6 (the sample shards' partial sums add in
  another order), the reference's tests/test_sharding.py tolerance;
- the sharded train step of tests/test_torch_train.py's setting (16x8,
  depth 3, 2 spp a rank, the material colours' x raised by 0.2, SGD at
  lr 0.5 on the material colours only, the reference's work-queue render
  at 4 spp as the target), against the reference's `make_train_step` on
  a virtual-device mesh of the same shape, first call only (its second
  call fails, ROADMAP Queue 3), with its FETCH_MODE "high": the loss
  within 1e-4 relative, every updated param within 1e-6,
  test_torch_train.py's tolerances; both ranks end with bit-equal params;
- a second port step, which must lower the loss.
The reference's step and target are read from the golden
tests/golden/jax_ref/torch_sharded.npz (torch_sharded_spp.npz for the
(1x2) mesh), which tools/make_jax_goldens.py records from the frozen
package.  The ranks run each on one intra-op thread (OMP_NUM_THREADS),
since they share the host's cores with the other test workers.
"""
import jax
import numpy as np
import pytest
import torch

from path_tracer_tpu.scene.presets import THREE_SPHERES
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.diff import params as TP
from path_tracer_tpu_torch.engine.wq import render_wq
from path_tracer_tpu_torch.parallel import launch
from path_tracer_tpu_torch.parallel import mesh as TM
from path_tracer_tpu_torch.parallel.multihost import assemble_image
from test_torch_train import step_golden
from tools.make_jax_goldens import perturb

W, H, DEPTH, SPP, LOCAL_SPP, LR = 16, 8, 3, 4, 2, 0.5
SHAPE = (2, 1)


def _only_material_colors(grads):
    scene_g, cam_g = grads
    zs, zc = TP.tree_map(lambda g: None if g is None else torch.zeros_like(g),
                         grads)
    return (zs._replace(materials=zs.materials._replace(
        color=scene_g.materials.color)), zc)


def _numpy(tree):
    return TP.tree_map(lambda x: None if x is None else x.numpy(), tree)


def rank_work(scene_np, cam_np, target, shape):
    """One rank on a mesh of `shape`: the assembled frame, two train
    steps' losses and the first step's params (numpy)."""
    scene, cam = scene_from_numpy(scene_np, "cpu"), camera_from_numpy(cam_np)
    params, (s_scene, s_cam) = TM.scene_camera_params(scene, cam)
    params = perturb(params, 0.2)
    target = torch.from_numpy(target)
    pix = torch.arange(W * H)
    mesh = TM.make_mesh(*shape, device="cpu")
    fb = TM.render_sharded(scene, cam, W, H, SPP, mesh, max_depth=DEPTH)
    step = TM.make_train_step(s_scene, s_cam, W, H, LOCAL_SPP, DEPTH, lr=LR,
                              grad_filter=_only_material_colors, mesh=mesh)
    new, loss = step(params, target, pix)
    _, loss2 = step(new, target, pix)
    return dict(frame=assemble_image(fb, mesh, W, H), new=_numpy(new),
                losses=[float(loss), float(loss2)],
                tile=(mesh.tile, mesh.spp))


def run_both(shape, name):
    """The two ranks' results at `shape`, the reference's first step on
    the same mesh shape (golden `name`), the port's render_wq frame and
    the perturbed params."""
    js, jc = THREE_SPHERES.build()
    scene_np = jax.tree_util.tree_map(np.asarray, js)
    cam_np = jax.tree_util.tree_map(np.asarray, jc)
    scene, cam = scene_from_numpy(scene_np, "cpu"), camera_from_numpy(cam_np)
    single = render_wq(scene, cam, W, H, SPP, max_depth=DEPTH,
                       device="cpu").numpy()
    target, jnew, jloss = step_golden(name, shape)
    with pytest.MonkeyPatch.context() as env:
        env.setenv("OMP_NUM_THREADS", "1")      # read by the spawned ranks
        ranks = launch.spawn(rank_work, 2, (scene_np, cam_np, target, shape),
                             device="cpu")
    ref = [x.numpy() for x in TP.leaves(jnew)]
    params = perturb(TM.scene_camera_params(scene, cam)[0], 0.2)
    return dict(shape=shape, single=single, ranks=ranks, ref=ref,
                jloss=jloss, params=params)


def check_frame(runs):
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["frame"], runs["single"], rtol=1e-5,
                                   atol=1e-6)


def check_grid(runs):
    """spp is the faster axis: rank r has tile r // n_spp, spp r % n_spp."""
    n_spp = runs["shape"][1]
    assert [r["tile"] for r in runs["ranks"]] == [
        (i // n_spp, i % n_spp) for i in range(2)]


def check_loss(runs):
    jloss = runs["jloss"]
    for r in runs["ranks"]:
        loss = r["losses"][0]
        assert np.isfinite(loss) and loss > 0
        assert abs(loss - jloss) <= 1e-4 * jloss, (loss, jloss)


def check_params(runs):
    old, ref = TP.leaves(runs["params"]), runs["ref"]
    for r in runs["ranks"]:
        new = TP.leaves(r["new"])
        assert len(old) == len(new) == len(ref)
        moved = 0
        for o, n, j in zip(old, new, ref):
            np.testing.assert_allclose(n, j, rtol=0, atol=1e-6)
            moved += bool(np.any(n != o.numpy()))
        assert moved == 3          # only the material colours move


def check_same_params(runs):
    a, b = (TP.leaves(r["new"]) for r in runs["ranks"])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))


def check_loss_falls(runs):
    for r in runs["ranks"]:
        first, second = r["losses"]
        assert np.isfinite(second) and second < first, (first, second)


@pytest.fixture(scope="module")
def runs():
    return run_both(SHAPE, "torch_sharded")


def test_assembled_frame_matches_render_wq(runs):
    check_frame(runs)


def test_ranks_sit_on_the_grid(runs):
    check_grid(runs)


def test_loss_matches_reference(runs):
    check_loss(runs)


def test_updated_params_match_reference(runs):
    check_params(runs)


def test_ranks_end_with_the_same_params(runs):
    check_same_params(runs)


def test_two_steps_lower_the_loss(runs):
    check_loss_falls(runs)
