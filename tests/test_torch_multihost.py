"""Joining a process group, the mesh over it, and the distributed dry run,
on the CPU (no JAX in this file, so the spawned ranks start quickly).

- In one process `bring_up()` does nothing, the mesh is 1x1 and its
  reductions leave a tensor as it is.
- In two processes started by `parallel.launch.spawn`, `bring_up()` joins
  the gloo group that RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
  MASTER_PORT describe (what `torchrun` sets), and `global_mesh` covers
  both ranks; a rank that raises stops the run with its traceback.
- `dryrun.dryrun_multichip(2)` runs on the CPU: the sharded final scene
  against the whole frame, the texel service in the recording, two train
  steps that lower the loss.
- The sharded train step refuses pixels that do not split evenly over
  the tiles axis, as the reference's shard_map does.
Each spawned rank runs one intra-op thread (OMP_NUM_THREADS), since the
ranks share the host's cores with the other test workers.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from path_tracer_tpu_torch import dryrun
from path_tracer_tpu_torch.parallel import launch
from path_tracer_tpu_torch.parallel import mesh as TM
from path_tracer_tpu_torch.parallel import multihost as MH
from path_tracer_tpu_torch.scene import presets as TP


@pytest.fixture(autouse=True)
def one_thread_a_rank(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_bring_up_is_a_no_op_in_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    MH.bring_up(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    MH.bring_up(device="cpu")
    assert not dist.is_initialized()
    mesh = MH.global_mesh(device="cpu")
    assert (mesh.shape, mesh.tile, mesh.spp) == ({"tiles": 1, "spp": 1}, 0, 0)
    t = torch.arange(4.0)
    assert mesh.psum(t, "tiles") is t and mesh.psum(t, "spp") is t
    assert torch.equal(t, torch.arange(4.0)) and mesh.collectives == 0
    with pytest.raises(ValueError, match="needs a process group"):
        TM.make_mesh(2, 1, device="cpu")


def test_one_process_assembles_its_one_tile():
    scene, cam = TP.THREE_SPHERES.build(device="cpu")
    mesh = TM.make_mesh(device="cpu")
    fb = TM.render_sharded(scene, cam, 8, 4, 2, mesh, max_depth=2)
    img = MH.assemble_image(fb, mesh, 8, 4)
    from path_tracer_tpu_torch.engine.wq import render_wq
    ref = render_wq(scene, cam, 8, 4, 2, max_depth=2, device="cpu").numpy()
    np.testing.assert_array_equal(img, ref)


def joined():
    """One rank: what it sees of the group bring_up joined."""
    mesh = MH.global_mesh(2, device="cpu")
    t = torch.tensor([float(dist.get_rank() + 1)])
    mesh.psum(t, "spp")
    tiles = TM.make_mesh(2, 1, group=dist.group.WORLD, device="cpu")
    return dict(env=(os.environ["RANK"], os.environ["WORLD_SIZE"],
                     os.environ["LOCAL_RANK"]),
                rank=dist.get_rank(), world=dist.get_world_size(),
                backend=dist.get_backend(), shape=mesh.shape,
                place=(mesh.tile, mesh.spp), total=float(t[0]),
                collectives=mesh.collectives,
                tiles_place=(tiles.tile, tiles.spp))


def fails():
    if dist.get_rank() == 1:
        raise RuntimeError("rank one gives up")
    return "fine"


def test_bring_up_joins_from_the_environment():
    res = launch.spawn(joined, 2, device="cpu")
    for r, out in enumerate(res):
        assert out["env"] == (str(r), "2", str(r))
        assert (out["rank"], out["world"], out["backend"]) == (r, 2, "gloo")
        assert out["shape"] == {"tiles": 1, "spp": 2}
        assert out["place"] == (0, r)
        assert out["total"] == 3.0 and out["collectives"] == 1
        assert out["tiles_place"] == (r, 0)


def test_a_failing_rank_stops_the_run():
    with pytest.raises(RuntimeError, match="rank one gives up"):
        launch.spawn(fails, 2, device="cpu", timeout=120)


def test_default_backend():
    assert launch.default_backend("cpu", 2) == "gloo"


def test_shard_plan_covers_the_frame():
    """Pixel shards tile [0, n_pix) and sample shards [0, spp), each
    (pixel, sample) once, for ragged and even splits."""
    for w, h, spp, n_tiles, n_spp in [(15, 7, 3, 2, 2), (16, 8, 4, 4, 2),
                                      (5, 3, 7, 3, 3), (800, 600, 80, 1, 1)]:
        seen = np.zeros((w * h, spp), int)
        for t in range(n_tiles):
            for k in range(n_spp):
                p = TM.shard_plan(w, h, spp, n_tiles, n_spp, t, k)
                assert p["spp_loc"] % p["chunk"] == 0
                pix = p["pix_base"] + np.arange(p["valid_pix"])
                samp = p["samp_base"] + np.arange(p["valid_cpp"] * p["chunk"])
                seen[np.ix_(pix, samp)] += 1
        assert (seen == 1).all(), (w, h, spp, n_tiles, n_spp)


def test_train_step_needs_pixels_that_split_over_the_tiles():
    """A (2x1) mesh's step refuses 33 pixels before any collective (no
    process group is needed to see it)."""
    scene, cam = TP.THREE_SPHERES.build(device="cpu")
    params, (s_scene, s_cam) = TM.scene_camera_params(scene, cam)
    mesh = TM.Mesh(2, 1, 0, 0, torch.device("cpu"))
    step = TM.make_train_step(s_scene, s_cam, 11, 3, 2, 2, mesh=mesh)
    with pytest.raises(ValueError, match="33 pixels do not split evenly"):
        step(params, torch.zeros(33, 3), torch.arange(33))


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    r = dryrun.dryrun_multichip(2, device="cpu")
    assert r["mesh"] == (2, 1)
    assert r["err"] < 1e-4 and r["ok"] and r["n_fix"] > 0
    assert r["losses"][1] < r["losses"][0]
    assert "OK" in capsys.readouterr().out
