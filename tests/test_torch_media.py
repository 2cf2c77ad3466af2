"""One bounce on a scene with 6 media, the port against the reference.

The bounce kernel is templated for 1..4 media; more take its run-time
instantiation, whose plain version is the same `bounce_core.wave_step`.
`probe.media_scene` is the final scene with five more smoke volumes
(sphere and box boundaries), each followed by a static and a moving
sphere, so the sphere fold has spheres of both kinds in every media
segment.  The port builds it; the reference gets the same tables through
its own `pack_scene` (the scene carried across field by field), and its
kernel runs in interpret mode.  Tolerances and their reasons are those of
tests/test_torch_bounce.py: integer planes equal on >= 99.5% of lanes,
float planes within 2e-3 relative on every lane whose win agrees and
within 4 ulp on >= 85% of them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.core import camera as JC
from path_tracer_tpu.core import vec as JV
from path_tracer_tpu.ops.pallas import wave_bounce as JWB
from path_tracer_tpu.scene import types as JT
from path_tracer_tpu_torch.engine.wq import _pack_atlas_flat
from path_tracer_tpu_torch.ops import probe
from path_tracer_tpu_torch.ops import wave_bounce as WB

W, H = 800, 600
N_MEDIA = 6
SEED = 13
KW = dict(t_min=1e-3, max_depth=4, attenuate=False, tile_rows=8)
_JAX_TYPES = {c.__name__: c for c in (
    JT.Scene, JT.Spheres, JT.Rects, JT.Triangles, JT.Media, JT.Materials,
    JT.Textures, JV.Vec3, JC.Camera)}


def to_jax(node):
    """A port NamedTuple tree as the reference's, leaf by leaf."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return _JAX_TYPES[type(node).__name__](*map(to_jax, node))
    return jnp.asarray(node.numpy())


@pytest.fixture(scope="module")
def case():
    scene, cam = probe.media_scene(W / H, N_MEDIA, device="cpu")
    tables = WB.pack_scene(scene)._replace(
        cam=WB.pack_camera(cam, W, H, device="cpu"), seed=SEED)
    atlas, _ = _pack_atlas_flat(scene.textures.atlas)
    st, fix, texel, srv = probe.probe_state(
        tables, cam, W, H, atlas, rows=8, bounces=3, max_depth=4, seed=5)
    port = WB.wave_bounce(tables, st, fix, texel, srv, **KW)

    js, jc = to_jax(scene), to_jax(cam)
    jt = JWB.pack_scene(js)._replace(cam=JWB.pack_camera(jc, W, H),
                                     seed=jnp.array([SEED], jnp.uint32))
    jst = JWB.WaveState(*[jnp.asarray(v.numpy().astype(np.uint32))
                          if k == "rng" else jnp.asarray(v.numpy())
                          for k, v in st._asdict().items()])
    jo = JWB.wave_bounce(jt, jst, JWB.FixState(*[jnp.asarray(v.numpy())
                                                 for v in fix]),
                         jnp.asarray(texel.numpy().astype(np.uint32)),
                         jnp.asarray(srv.numpy()), interpret=True, **KW)
    t = lambda x: torch.from_numpy(np.asarray(x).astype(
        np.int64 if x.dtype == jnp.uint32 else np.asarray(x).dtype))
    ref = WB.WaveOut(state=WB.WaveState(*map(t, jo.state)),
                     fix=WB.FixState(*map(t, (jo.fix_kind, jo.fix_idx, jo.fwx,
                                              jo.fwy, jo.fwz))),
                     win=t(jo.win), t_hit=t(jo.t_hit))
    return dict(tables=tables, jt=jt, port=port, ref=ref,
                agree=probe.agreement(ref, port))


def test_the_scene_packs_six_media_with_spheres_in_every_segment(case):
    tables = case["tables"]
    assert tables.med.shape == (17, N_MEDIA)
    assert N_MEDIA > 4       # past the kernel's templated counts
    np.testing.assert_array_equal(tables.sph_segs.numpy(),
                                  np.asarray(case["jt"].sph_segs))
    segs = tables.sph_segs.tolist()
    starts = [0] + [end for _, end in segs[:-1]]
    for start, (static_end, end) in zip(starts[1:], segs[1:]):
        assert start < static_end < end        # static and moving spheres


def test_media_win_lanes(case):
    """Lanes end their segment inside every kind of medium boundary: the
    winner's class is a medium on many lanes."""
    win = case["ref"].win
    cls = torch.remainder(torch.div(win - 1, 1024, rounding_mode="floor"), 4)
    assert int(((win > 0) & (cls == 3)).sum()) > 100


@pytest.mark.parametrize("plane", probe.INT_PLANES)
def test_integer_planes_match_reference(case, plane):
    assert case["agree"][plane] >= 0.995, case["agree"]


@pytest.mark.parametrize("plane", probe.FLOAT_PLANES + probe.FIX_PLANES)
def test_float_planes_match_reference(case, plane):
    a, b = probe.planes(case["ref"]), probe.planes(case["port"])
    m = a["win"] == b["win"]
    if plane in probe.FIX_PLANES:
        m = m & (a["fix_kind"] != 0) & (b["fix_kind"] != 0)
    x, y = a[plane][m].double(), b[plane][m].double()
    rel = (x - y).abs() / torch.clamp(torch.maximum(x.abs(), y.abs()), min=1)
    assert float(rel.max()) <= 2e-3, plane
    assert case["agree"][plane] >= 0.85, (plane, case["agree"])
