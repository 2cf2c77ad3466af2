"""K1's variant choice (`ops.wave_bounce.k1_variant`), a pure function,
on the CPU; no JAX.

The five presets and the run-time media counts keep the instantiations
they had (the fold table staged in shared memory); a scene past either
shared-memory cap takes the global variant: more than 23 media
(`probe.media_scene` with 24 and 30) or a fold table over 192 KB
(`probe.sphere_scene`'s 13,000 static spheres, 216,640 bytes).  On CPU
tensors the wrapper counts no launch for such a scene either.  The card's tests (tests/test_torch_kernel.py, `-m
cuda`) hold the global variant bit-equal to the plain version.
"""
import pytest

from path_tracer_tpu_torch.engine.wq import _pack_atlas_flat
from path_tracer_tpu_torch.ops import probe
from path_tracer_tpu_torch.ops import wave_bounce as WB
from path_tracer_tpu_torch.scene.presets import PRESETS

KW = dict(t_min=1e-3, max_depth=4, attenuate=False)


def _variant(scene):
    t = WB.pack_scene(scene)
    return WB.k1_variant(t.med.shape[1], t.fold.shape[0] * 16), t


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_keep_their_variant(name):
    scene, _ = PRESETS[name].build(device="cpu")
    variant, t = _variant(scene)
    assert variant == "templated", (t.med.shape, t.fold.shape)


@pytest.mark.parametrize("n_media, want", [(4, "templated"), (5, "run-time"),
                                           (6, "run-time"), (24, "global"),
                                           (30, "global")])
def test_media_counts(n_media, want):
    scene, _ = probe.media_scene(4 / 3, n_media, device="cpu")
    variant, t = _variant(scene)
    assert t.med.shape[1] == n_media and variant == want


def test_thirteen_thousand_spheres_take_the_global_variant():
    scene, _ = probe.sphere_scene(4 / 3, device="cpu")
    variant, t = _variant(scene)
    assert variant == "global"
    assert t.fold.shape[0] * 16 > 208 * 1024
    assert int((scene.spheres.time0 == scene.spheres.time1).sum()) >= 13000


def test_the_caps_are_the_boundaries():
    assert WB.k1_variant(1, WB.MAX_FOLD_BYTES) == "templated"
    assert WB.k1_variant(1, WB.MAX_FOLD_BYTES + 16) == "global"
    assert WB.k1_variant(WB.MAX_MED, 16) == "run-time"
    assert WB.k1_variant(WB.MAX_MED + 1, 16) == "global"
    assert WB.k1_variant(0, 16) == "global"


def test_cpu_tensors_take_the_plain_version_past_the_caps():
    scene, cam = probe.media_scene(800 / 600, 30, device="cpu")
    tables = WB.pack_scene(scene)._replace(
        cam=WB.pack_camera(cam, 800, 600, device="cpu"), seed=3)
    atlas, _ = _pack_atlas_flat(scene.textures.atlas)
    st, fix, texel, srv = probe.probe_state(tables, cam, 800, 600, atlas,
                                            rows=8, bounces=2, max_depth=4)
    before = WB.wave_bounce.launches
    out = WB.wave_bounce(tables, st, fix, texel, srv, tile_rows=8, **KW)
    assert WB.wave_bounce.launches == before
    # some lanes' winners are among the 30 media
    cls = (out.win - 1).div(1024, rounding_mode="floor").remainder(4)
    assert int(((out.win > 0) & (cls == 3)).sum()) > 0
