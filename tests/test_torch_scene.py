"""The port's scene build and table packing against the reference package.

Every array of every preset must equal the reference build bit for bit
(the builders run the same host-side numpy and float32 xorshift), and so
must the kernel tables packed from it: pack_scene, pack_camera and the
flat atlas.
"""
import jax
import numpy as np
import pytest
import torch

from path_tracer_tpu.engine import wq as JWQ
from path_tracer_tpu.ops.pallas import wave_bounce as JWB
from path_tracer_tpu.scene import presets as JP
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.engine import wq as TWQ
from path_tracer_tpu_torch.ops import wave_bounce as TWB
from path_tracer_tpu_torch.scene import presets as TP


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_equal(jtree, ttree, path="scene"):
    if isinstance(jtree, tuple):
        assert type(jtree).__name__ == type(ttree).__name__, path
        for f in jtree._fields:
            _assert_tree_equal(getattr(jtree, f), getattr(ttree, f),
                               f"{path}.{f}")
        return
    a = np.asarray(jtree)
    b = ttree.cpu().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=path)
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("name", sorted(JP.PRESETS))
def test_preset_arrays_bit_equal(name):
    js, _ = JP.PRESETS[name].build()
    ts, _ = TP.PRESETS[name].build(device="cpu")
    _assert_tree_equal(js, ts)


def test_scene_from_numpy_round_trip():
    js, jc = JP.build_final_scene(1.5)
    _assert_tree_equal(js, scene_from_numpy(_np(js), "cpu"))
    _assert_tree_equal(jc, camera_from_numpy(_np(jc)), "camera")


def test_build_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.THREE_SPHERES.build()


@pytest.mark.parametrize("name", ["final_scene", "cornell_box"])
def test_packed_tables_bit_equal(name):
    preset = JP.PRESETS[name]
    js, jc = preset.build()
    ts, _ = TP.PRESETS[name].build(device="cpu")
    jt = JWB.pack_scene(js)
    tt = TWB.pack_scene(ts)
    for field in ("sph", "sph_segs", "rect", "rect_segs", "tri", "tri_segs",
                  "med", "spec"):
        _assert_tree_equal(getattr(jt, field), getattr(tt, field), field)
    _assert_tree_equal(JWB.pack_camera(jc, preset.width, preset.height),
                       TWB.pack_camera(camera_from_numpy(_np(jc)),
                                       preset.width, preset.height,
                                       device="cpu"), "cam")
    jflat, jn = JWQ._pack_atlas_flat(js.textures.atlas)
    tflat, tn = TWQ._pack_atlas_flat(ts.textures.atlas)
    assert jn == tn
    np.testing.assert_array_equal(np.asarray(jflat).astype(np.int64),
                                  tflat.numpy().astype(np.int64))


def test_final_scene_table_sizes():
    ts, _ = TP.build_final_scene(800 / 600, device="cpu")
    tt = TWB.pack_scene(ts)
    assert tt.sph.shape[0] == 15 and tt.rect.shape[0] == 15
    assert tt.tri.shape[0] == 17 and tt.med.shape[0] == 17
    assert tuple(tt.spec.shape) == (11, 16)
    # the smoke ball is the last hittable: every sphere precedes it, and
    # the fold's last segment holds only the padding
    assert int(tt.sph_segs[0, 1]) == int(ts.spheres.active.sum())
    assert int(tt.sph_segs[-1, 1]) == tt.sph.shape[1]
