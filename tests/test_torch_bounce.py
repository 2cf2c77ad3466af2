"""One bounce of the port's `wave_bounce` against the reference kernel.

The input is a final-scene state a few bounces in (ops.probe.probe_state,
from a numpy seed): live and dead lanes, in-chunk regeneration, pending
ALBEDO and EMIT fixups and stalled lanes.  The same state goes through the
reference's `wave_bounce(interpret=True)` and the port's plain version.

Tolerances, and why:
* integer planes (rng, win, alive, s, bnc, wrk, fix_kind) equal on
  >= 99.5% of lanes: a knife-edge lane (docs/PERF_NOTES.md:67-75) may take
  the other discrete branch after a one-rounding difference;
* float planes, on the lanes whose win agrees: every lane within 2e-3
  relative (magnitudes floored at 1), and >= 85% of lanes within 4 ulp.
  The 4-ulp bound cannot hold on every lane, because the reference's CPU
  run is not op-by-op float32: XLA's CPU compiler contracts a*b+c into
  one fused multiply-add (jit(a*b+c) equals the fused result on all of
  200K random inputs), and the ground sphere's r=1000 quadratic (the
  cancellation in |c-o|^2 - r^2) amplifies that one rounding to ~200 ulp
  of t on a few percent of lanes.  The port rounds every op, as the
  CUDA kernel (built with -fmad=false) does.
  Fixup planes are compared where a fixup is pending in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.ops.pallas import wave_bounce as JWB
from path_tracer_tpu.scene.presets import build_final_scene
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.engine.wq import _pack_atlas_flat
from path_tracer_tpu_torch.ops import probe
from path_tracer_tpu_torch.ops import wave_bounce as WB

W, H = 800, 600
SEED = 7
MAX_DEPTH = 4      # three bounces in, so the probe call exhausts paths too
KW = dict(t_min=1e-3, max_depth=MAX_DEPTH, attenuate=False, tile_rows=8)


@pytest.fixture(scope="module")
def case():
    js, jc = build_final_scene(W / H)
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    cam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jc))
    tables = WB.pack_scene(scene)._replace(
        cam=WB.pack_camera(cam, W, H, device="cpu"), seed=SEED)
    atlas, _ = _pack_atlas_flat(scene.textures.atlas)
    st, fix, texel, srv = probe.probe_state(
        tables, cam, W, H, atlas, rows=8, bounces=3, max_depth=MAX_DEPTH,
        seed=3)
    port = WB.wave_bounce(tables, st, fix, texel, srv, **KW)

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
    return dict(st=st, fix=fix, texel=texel, srv=srv, port=port, ref=ref,
                agree=probe.agreement(ref, port))


def test_probe_state_covers_every_policy_case(case):
    st, fix, srv = case["st"], case["fix"], case["srv"]
    pending = fix.kind != 0
    assert int((fix.kind == WB.FIX_ALBEDO).sum()) > 0
    assert int((fix.kind == WB.FIX_EMIT).sum()) > 0
    assert int((pending & (srv == 0)).sum()) > 0          # stalls
    assert int((pending & (srv > 0)).sum()) > 0           # served fixups
    assert int((st.alive == 0).sum()) > 0                 # dead lanes
    assert int((st.s + st.strd < st.send).sum()) > 0      # can regenerate
    win = case["ref"].win
    term = torch.div(win - 1, 4096, rounding_mode="floor")
    # the call continues paths and ends them by sky and depth exhaustion
    for code in (0, 1, 4):
        assert int(((win > 0) & (term == code)).sum()) > 0, code


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
