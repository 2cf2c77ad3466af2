"""The port's work-queue render against the reference's, on the CPU.

The same scene (carried across with `convert`) goes through the
reference's `render_wq` (its kernel in interpret mode; read from the
golden tests/golden/jax_ref/<name>.npz, which tools/make_jax_goldens.py
records from the frozen package at these inputs) and the port's
`render_wq(device="cpu")` (the kernel's plain version).  The envelope is
tests/test_wq.py's: knife-edge pixels, where a one-rounding difference
flips a discrete branch (docs/PERF_NOTES.md:67-75), may deviate, so at
most 3% of pixels beyond 5e-3, traced segments within 0.2%, and the same
number of bounce iterations.  This file runs the final scene at 24x16,
4 spp, depth 8 (tile_rows=4, window=3); test_torch_wq_drain.py runs the
drain-stage configuration.
"""
import jax
import numpy as np
import pytest
import torch

from path_tracer_tpu.engine import wq as JWQ
from path_tracer_tpu.ops.pallas import wave_bounce as JWB
from path_tracer_tpu.scene.presets import build_final_scene
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.engine import wq as TWQ
from path_tracer_tpu_torch.ops import probe as TPB
from path_tracer_tpu_torch.ops import wave_bounce as TWB
from path_tracer_tpu_torch.scene import presets as TP
from tools import make_jax_goldens as golden


def render_both(name, w, h, spp, depth, tile_rows, window):
    """The reference's render of the final scene (golden `name`) and the
    port's, each as (img, segments, iterations, lane steps)."""
    g = golden.load(name, dict(scene="final_scene", aspect=1.5, width=w,
                               height=h, spp=spp, max_depth=depth,
                               tile_rows=tile_rows, window=window))
    js, jc = build_final_scene(1.5)
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    cam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jc))
    port = TWQ.render_wq(scene, cam, w, h, spp, max_depth=depth,
                         tile_rows=tile_rows, window=window,
                         return_stats=True, device="cpu")
    return ([g["img"], float(g["segs"]), int(g["iters"]), float(g["lanes"])],
            [port[0].numpy(), port[1], port[2], port[3]])


def assert_envelope(ref, port):
    (rimg, rsegs, riters, rlanes), (img, segs, iters, lanes) = ref, port
    assert img.shape == rimg.shape and np.isfinite(img).all()
    d = np.abs(img - rimg).max(axis=-1)
    assert float((d > 5e-3).mean()) <= 0.03, float(d.max())
    assert abs(segs - rsegs) <= 0.002 * rsegs, (segs, rsegs)
    assert iters == riters
    assert lanes == rlanes


@pytest.fixture(scope="module")
def final_24x16():
    return render_both("torch_wq", 24, 16, 4, 8, tile_rows=4, window=3)


def test_render_wq_final_scene_matches_reference(final_24x16):
    assert_envelope(*final_24x16)


def test_render_wq_occupancy_and_path_length(final_24x16):
    _, (img, segs, iters, lanes) = final_24x16
    assert 0.0 < segs / lanes <= 1.0
    assert 1.0 < segs / (24 * 16 * 4) < 8.0   # mean segments a sample


def test_render_wq_range_sums_compose():
    """Two sample ranges add up to the whole frame's sums (streams are
    keyed on the global (pixel, sample) pair)."""
    scene, cam = TP.build_final_scene(1.5, device="cpu")
    kw = dict(max_depth=4, tile_rows=8, window=3, device="cpu")
    whole = TWQ.render_wq_range(scene, cam, 8, 8, 0, 4, **kw)
    parts = (TWQ.render_wq_range(scene, cam, 8, 8, 0, 2, **kw)
             + TWQ.render_wq_range(scene, cam, 8, 8, 2, 2, **kw))
    img = TWQ.render_wq(scene, cam, 8, 8, 4, **{k: v for k, v in kw.items()})
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), atol=1e-5)
    np.testing.assert_allclose((whole / 4.0).reshape(8, 8, 3).numpy(),
                               img.numpy(), atol=1e-6)


def test_render_wq_default_device_raises_without_cuda(monkeypatch):
    scene, cam = TP.THREE_SPHERES.build(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TWQ.render_wq(scene, cam, 8, 8, 1)


@pytest.mark.parametrize("spp,chunk", [(80, 10), (100, 10), (500, 10),
                                       (2, 2), (12, 6), (7, 7), (11, 1),
                                       (1, 1)])
def test_pick_chunk(spp, chunk):
    assert TWQ.pick_chunk(spp) == chunk == JWQ.pick_chunk(spp)


def test_add_in_order_is_a_sequential_scatter_add():
    """The deposit adds each entry's contributions one after another in
    index order, bit for bit like a sequential loop (the reference's
    scatter-add on the CPU), and drops the drop slot."""
    rs = np.random.RandomState(0)
    n_slots, n = 50, 4000
    idx = rs.randint(0, n_slots + 1, n)               # n_slots = drop slot
    vals = rs.standard_normal(n).astype(np.float32)
    fb = rs.standard_normal(n_slots + 1).astype(np.float32)
    want = fb.copy()
    for i, v in zip(idx, vals):
        if i < n_slots:
            want[i] = np.float32(want[i] + v)
    cap = int(np.bincount(idx, minlength=n_slots + 1)[:n_slots].max())
    got = TWQ._add_in_order(torch.from_numpy(fb), torch.from_numpy(idx),
                            torch.from_numpy(vals), n_slots, cap)
    np.testing.assert_array_equal(got.numpy()[:n_slots].view(np.uint32),
                                  want[:n_slots].view(np.uint32))


def _crowded(k):
    """Random pending fixups, 0-30% of a row's lanes, on 16 rows."""
    rs = np.random.RandomState(10 + k)
    rows = 16
    kind = np.where(rs.rand(rows, 128) < np.linspace(0, 0.3, rows)[:, None],
                    rs.randint(1, 3, (rows, 128)), 0).astype(np.float32)
    idx = rs.randint(0, 4096, (rows, 128)).astype(np.float32)
    return kind, idx, rs.randint(0, 256, (4096, 3)).astype(np.uint8)


def _texel_edge(case):
    kind, idx, _ = TPB.texel_edge(case)
    rs = np.random.RandomState(99)
    return kind, idx, rs.randint(0, 256, (TPB.TEXEL_ATLAS, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("case,k", [
    *(pytest.param(None, k, id=str(k)) for k in (0, 1, 5)),
    *(pytest.param(case, k, id=f"{case}-{k}")
      for case in TPB.TEXEL_EDGES
      for k in TPB.texel_edge(case)[2])])
def test_texel_service_matches_reference(case, k):
    """Slots and heavy-row spill on a random pending-fixup state with
    crowded rows, and on the service's edge states (`probe.texel_edge`:
    one row, more heavy rows than the cap, a full row, the row rotation
    at the last row, nothing pending, negative and non-integral indices,
    a frame's width): the same texels and coverage as the reference."""
    kind, idx, atlas = _crowded(k) if case is None else _texel_edge(case)
    jflat, n = JWQ._pack_atlas_flat(jax.numpy.asarray(atlas))
    tflat, _ = TWQ._pack_atlas_flat(torch.from_numpy(atlas))
    z = np.zeros_like(kind)
    jfx = JWB.FixState(*map(jax.numpy.asarray, (kind, idx, z, z, z)))
    tfx = TWB.FixState(*map(torch.from_numpy, (kind, idx, z, z, z)))
    jtex, jsrv = JWQ.texel_service(jfx, k, jflat, n)
    ttex, tsrv = TWQ.texel_service(tfx, k, tflat, n)
    np.testing.assert_array_equal(np.asarray(jsrv), tsrv.numpy())
    m = np.asarray(jsrv) > 0
    np.testing.assert_array_equal(np.asarray(jtex).astype(np.int64)[m],
                                  ttex.numpy().astype(np.int64)[m])
    if case is None:
        assert m.sum() > 0 and (m != (kind != 0)).sum() > 0   # some stall
    elif case == "none_pending":
        assert m.sum() == 0
    else:
        assert m.sum() > 0
