"""The work-queue core over one shard of the frame, in one process.

`engine.wq.wq_window_fb` takes the reference's shard arguments (pix_base,
valid_pix, valid_cpp beside samp_base), which `parallel.mesh.shard_plan`
sets as the reference's `render_sharded` does.  Here every shard of a
(tiles, spp) split is rendered in turn and the shards are put together
(pixel shards side by side, sample shards summed) and held against the
whole frame's `render_wq_range` sums: bit-equal where each pixel has one
chunk of samples (its radiance is then one lane's sum, deposited once),
else within rtol 1e-5, atol 1e-6 (the sample shards' partial sums add in
another order), the reference's tests/test_sharding.py tolerance.  The
three-sphere scene at 16x8 and at the ragged 15x7, whose last pixel
shard and last sample shard are short.

One shard also goes through the reference's `wq_window_fb` (its kernel
in interpret mode) with the same arguments, held to the envelope of
tests/test_wq.py:24-36 for this scene (no pixel beyond 2e-4), the same
bounce iterations and segments within 0.2%.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.engine import wq as JWQ
from path_tracer_tpu.scene.presets import THREE_SPHERES
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.engine import wq as TWQ
from path_tracer_tpu_torch.parallel.mesh import shard_plan
from path_tracer_tpu_torch.scene import presets as TP

DEPTH = 3
KW = dict(window=3, max_depth=DEPTH, attenuate=False, t_min=1e-3,
          tile_rows=8, seed=0, device=torch.device("cpu"))


@pytest.fixture(scope="module")
def scene_cam():
    return TP.THREE_SPHERES.build(device="cpu")


def shard_fb(scene, cam, w, h, spp, n_tiles, n_spp, tile, k):
    plan = shard_plan(w, h, spp, n_tiles, n_spp, tile, k)
    fb, segs, iters, lanes = TWQ.wq_window_fb(
        scene, cam, w, h, n_pix_loc=plan["n_pix_loc"],
        spp_loc=plan["spp_loc"], chunk=plan["chunk"],
        pix_base=plan["pix_base"], samp_base=plan["samp_base"],
        valid_pix=plan["valid_pix"], valid_cpp=plan["valid_cpp"], **KW)
    return fb, plan, segs, iters


def assembled(scene, cam, w, h, spp, n_tiles, n_spp):
    """Every shard's sums, pixel shards concatenated, sample shards
    summed, trimmed to the frame."""
    tiles = []
    for t in range(n_tiles):
        parts = [shard_fb(scene, cam, w, h, spp, n_tiles, n_spp, t, k)[0]
                 for k in range(n_spp)]
        tiles.append(functools.reduce(torch.add, parts))
    return torch.cat(tiles)[:w * h]


def whole(scene, cam, w, h, spp):
    return TWQ.render_wq_range(scene, cam, w, h, 0, spp, max_depth=DEPTH,
                               tile_rows=8, window=3, device="cpu")


@pytest.mark.parametrize("w,h", [(16, 8), (15, 7)])
def test_pixel_shards_are_bit_equal(scene_cam, w, h):
    """2 spp in one chunk a pixel: each pixel shard's sums are the whole
    frame's, bit for bit."""
    scene, cam = scene_cam
    got = assembled(scene, cam, w, h, 2, 2, 1)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  whole(scene, cam, w, h, 2).numpy()
                                  .view(np.uint32))


@pytest.mark.parametrize("w,h,spp,n_tiles,n_spp", [
    (16, 8, 4, 1, 2), (16, 8, 4, 2, 2), (15, 7, 3, 1, 2), (15, 7, 3, 2, 2)])
def test_sample_shards_sum_to_the_frame(scene_cam, w, h, spp, n_tiles,
                                        n_spp):
    scene, cam = scene_cam
    got = assembled(scene, cam, w, h, spp, n_tiles, n_spp)
    np.testing.assert_allclose(got.numpy(), whole(scene, cam, w, h, spp)
                               .numpy(), rtol=1e-5, atol=1e-6)


def test_ragged_shards_grant_only_their_work(scene_cam):
    """15x7 = 105 pixels over 2 tiles: the second shard holds 52 pixels
    and a zero row past the frame; 3 spp over 2 spp shards: the second
    gets one chunk of the three."""
    scene, cam = scene_cam
    fb, plan, _, _ = shard_fb(scene, cam, 15, 7, 3, 2, 2, 1, 1)
    assert plan == dict(chunk=1, spp_loc=2, n_pix_loc=53, pix_base=53,
                        samp_base=2, valid_pix=52, valid_cpp=1)
    assert fb.shape == (53, 3)
    assert float(fb[52].abs().sum()) == 0.0
    assert bool((fb[:52].sum(1) > 0).all())


def test_defaults_are_the_whole_frame(scene_cam):
    """With no shard arguments the core is `render_wq`'s call, bit for
    bit (the plan of a 1x1 mesh)."""
    scene, cam = scene_cam
    plan = shard_plan(16, 8, 4, 1, 1, 0, 0)
    fb, _, _, _ = TWQ.wq_window_fb(scene, cam, 16, 8, n_pix_loc=128,
                                   spp_loc=4, chunk=plan["chunk"], **KW)
    got, _, _ = shard_fb(scene, cam, 16, 8, 4, 1, 1, 0, 0)[:3]
    np.testing.assert_array_equal(fb.numpy().view(np.uint32),
                                  got.numpy().view(np.uint32))
    np.testing.assert_array_equal(fb.numpy().view(np.uint32),
                                  whole(scene, cam, 16, 8, 4).numpy()
                                  .view(np.uint32))


@pytest.fixture(scope="module")
def reference_shard():
    """tile 1 of 2, spp shard 1 of 2, on the ragged 15x7 frame at 3 spp,
    through both packages."""
    w, h, spp = 15, 7, 3
    js, jc = THREE_SPHERES.build()
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    cam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jc))
    fb, plan, segs, iters = shard_fb(scene, cam, w, h, spp, 2, 2, 1, 1)

    @jax.jit
    def ref(js, jc):
        return JWQ.wq_window_fb(
            js, jc, w, h, n_pix_loc=plan["n_pix_loc"],
            spp_loc=plan["spp_loc"], chunk=plan["chunk"], window=3,
            max_depth=DEPTH, attenuate=False, t_min=1e-3, tile_rows=8,
            interpret=True, seed=jnp.uint32(0), pix_base=plan["pix_base"],
            samp_base=plan["samp_base"], valid_pix=plan["valid_pix"],
            valid_cpp=plan["valid_cpp"])

    rfb, rsegs, riters, _ = ref(js, jc)
    return dict(fb=fb.numpy(), segs=segs, iters=iters, rfb=np.asarray(rfb),
                rsegs=float(rsegs), riters=int(riters))


def test_shard_matches_reference(reference_shard):
    r = reference_shard
    assert r["fb"].shape == r["rfb"].shape == (53, 3)
    d = np.abs(r["fb"] - r["rfb"]).max(axis=-1)
    assert float((d > 2e-4).mean()) == 0.0, float(d.max())
    assert r["iters"] == r["riters"]
    assert abs(r["segs"] - r["rsegs"]) <= 0.002 * r["rsegs"]
