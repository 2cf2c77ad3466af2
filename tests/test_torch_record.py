"""The port's recording work queue (`diff.queued_vjp.record_forward_q`)
against the reference's, on the CPU.

The final scene at 16x12, 2 spp, depth 4 (carried across with `convert`)
is recorded by the reference (its kernel in interpret mode; read from the
golden tests/golden/jax_ref/torch_record.npz, which
tools/make_jax_goldens.py records from the frozen package at these
inputs) and by the port (the kernel's plain version), with the schedule
both `render_grad_fb`s derive.  Tolerances, and why:
* schedule (here and at tools/bench_grad.py's 400x300, 4 spp, depth 50),
  `ok`, and the integer record planes pix, s, fresh, texel, fixk, perm
  and pvalid: equal entry for entry;
* `win`: equal on >= 99.9% of entries (measured 99.988%: 3 of 24,576
  stage-A entries).  A knife-edge lane (docs/PERF_NOTES.md:67-75) takes
  the other discrete branch after a one-rounding difference: XLA's CPU
  compiler contracts a*b+c into FMA, the port rounds every op
  (test_torch_bounce.py);
* segments within 0.2%, and the framebuffer inside tests/test_wq.py's
  envelope (at most 3% of pixels beyond 5e-3);
* t and the recorded directions on the lanes whose win agrees at every
  step of the stage: test_torch_bounce.py's float tolerance (within 2e-3
  relative, magnitudes floored at 1, and within 4 ulp on >= 85%), held on
  >= 99.5% of entries, with every entry within 5e-2.  That bound is for
  one bounce; along a recorded path the one-rounding differences compound
  bounce after bounce (the ground sphere's cancelling quadratic moves the
  hit point, the normal and the next direction), measured up to 2.0e-2 on
  0.18% of entries (dz), and 0.1% of stage-A lanes.

On the port alone, tests/test_queued_vjp.py's two envelopes: the replay
reconstructs the recorded framebuffer, and variable chunking (`tail_pix`)
changes no radiance (and, here, no segment count).
"""
import jax
import numpy as np
import pytest
import torch

from path_tracer_tpu.diff import queued_vjp as JQ
from path_tracer_tpu.scene.presets import build_final_scene
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.diff import queued_vjp as TQ
from tools import make_jax_goldens as golden

W, H, SPP, DEPTH = 16, 12, 2, 4
INT_PLANES = ("pix", "s", "fresh", "texel", "fixk")
FLOAT_PLANES = ("t", "dx", "dy", "dz")


def _rcfg(cfg):
    return {k: v for k, v in cfg.items() if k not in ("width", "height")}


def _record(scene, cam, **kw):
    f = TQ.render_grad_fb(W, H, W * H, SPP, max_depth=DEPTH, device="cpu",
                          **kw)
    fb, rec, ok = TQ.record_forward_q(scene, cam, W, H, 0, 0,
                                      **_rcfg(f.cfg))
    return f.cfg, fb, rec, ok


@pytest.fixture(scope="module")
def both():
    js, jc = build_final_scene(W / H)
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    cam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jc))
    jf = JQ.render_grad_fb(W, H, W * H, SPP, max_depth=DEPTH,
                           attenuate=True)
    g = golden.load("torch_record", dict(width=W, height=H, spp=SPP,
                                         max_depth=DEPTH, attenuate=True))
    stage = JQ.ResQ(*[0] * len(JQ.ResQ._fields))
    jrec = golden.unflatten(g, "rec", JQ.RecQ(stage, stage, 0, 0))
    cfg, fb, rec, ok = _record(scene, cam)
    return dict(scene=scene, cam=cam, jcfg=jf.cfg, jfb=g["fb"], jrec=jrec,
                jok=bool(g["ok"]), cfg=cfg, fb=fb, rec=rec, ok=bool(ok))


def test_schedule_and_ok_match(both):
    jcfg = {k: v for k, v in both["jcfg"].items() if k != "interpret"}
    cfg = {k: v for k, v in both["cfg"].items() if k != "device"}
    assert cfg == jcfg
    assert both["ok"] and both["jok"]
    assert both["rec"].a.win.shape == (24, 1024)
    assert both["rec"].b.win.shape == (32, 1024)


def test_full_width_schedule_matches_reference():
    """tools/bench_grad.py's setting (400x300, 4 spp, depth 50) at the
    card's tile_rows 64: the same schedule as the reference derives."""
    kw = dict(max_depth=50, tile_rows=64)
    cfg = TQ.render_grad_fb(400, 300, 400 * 300, 4, device="cpu", **kw).cfg
    jcfg = JQ.render_grad_fb(400, 300, 400 * 300, 4, **kw).cfg
    cfg = {k: v for k, v in cfg.items() if k != "device"}
    assert cfg == {k: v for k, v in jcfg.items() if k != "interpret"}
    assert (cfg["rows"], cfg["rows_b"], cfg["chunk"], cfg["window"]) == \
        (128, 8, 4, 16)
    assert cfg["n_windows"] * cfg["window"] == 144
    assert cfg["n_windows_b"] * cfg["window"] == 192


def test_segments_match(both):
    segs = float(TQ.rec_segments(both["rec"]))
    jsegs = float(JQ.rec_segments(both["jrec"]))
    assert segs > 0 and abs(segs - jsegs) <= 0.002 * jsegs, (segs, jsegs)


@pytest.mark.parametrize("stage", ["a", "b"])
@pytest.mark.parametrize("plane", INT_PLANES)
def test_integer_planes_equal(both, stage, plane):
    x = getattr(getattr(both["jrec"], stage), plane).astype(np.int64)
    y = getattr(getattr(both["rec"], stage), plane).numpy().astype(np.int64)
    np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("stage", ["a", "b"])
def test_win_planes_match(both, stage):
    x = getattr(both["jrec"], stage).win
    y = getattr(both["rec"], stage).win.numpy()
    assert (x == y).mean() >= 0.999, (x == y).mean()


def test_permutation_equal(both):
    jr, r = both["jrec"], both["rec"]
    pv = jr.pvalid
    np.testing.assert_array_equal(r.pvalid.numpy(), pv)
    np.testing.assert_array_equal(r.perm.numpy()[pv], jr.perm[pv])


@pytest.mark.parametrize("plane", FLOAT_PLANES)
def test_float_planes_match(both, plane):
    for stage in ("a", "b"):
        jres, res = getattr(both["jrec"], stage), getattr(both["rec"], stage)
        same = (jres.win == res.win.numpy()).all(axis=0)     # whole lanes
        x = getattr(jres, plane)[:, same].astype(np.float64)
        y = getattr(res, plane).numpy()[:, same].astype(np.float64)
        rel = np.abs(x - y) / np.maximum(np.maximum(np.abs(x), np.abs(y)),
                                         1.0)
        assert rel.max() <= 5e-2, (stage, plane, rel.max())
        assert (rel <= 2e-3).mean() >= 0.995, (stage, plane)
        xi = x.astype(np.float32).view(np.int32).astype(np.int64)
        yi = y.astype(np.float32).view(np.int32).astype(np.int64)
        assert (np.abs(xi - yi) <= 4).mean() >= 0.85, (stage, plane)


def test_framebuffer_in_wq_envelope(both):
    img = both["fb"].numpy() / SPP
    jimg = both["jfb"] / SPP
    assert np.isfinite(img).all() and img.shape == (W * H, 3)
    d = np.abs(img - jimg).max(axis=1)
    assert float((d > 5e-3).mean()) <= 0.03, float(d.max())


def test_replay_fb_matches_recorded_fb(both):
    with torch.no_grad():
        fb_r = TQ.replay_fb(both["scene"], both["cam"], both["rec"], 0,
                            width=W, height=H, npx=W * H,
                            attenuate=True, t_min=1e-3, seed=0,
                            window=both["cfg"]["window"]).numpy()
    fb = both["fb"].numpy()
    err = np.abs(fb - fb_r).max(axis=1)
    assert (err > 1e-4).mean() < 0.01, (err > 1e-4).mean()
    assert abs(fb_r.sum() - fb.sum()) / max(abs(fb.sum()), 1e-9) < 1e-3


def test_variable_chunking_preserves_radiance(both):
    """tail_pix splits late chunks into singles; streams are keyed on
    (pixel, sample), so per-pixel sums move only by deposit reassociation,
    and the same samples trace the same segments."""
    runs = [_record(both["scene"], both["cam"], tail_pix=tp)
            for tp in (0, W * H // 3)]
    assert all(bool(ok) for _, _, _, ok in runs)
    (_, fb0, rec0, _), (_, fb1, rec1, _) = runs
    assert float(TQ.rec_segments(rec0)) == float(TQ.rec_segments(rec1)) > 0
    fb0, fb1 = fb0.numpy(), fb1.numpy()
    err = np.abs(fb0 - fb1).max(axis=1)
    assert (err > 1e-4).mean() < 0.01
    assert abs(fb1.sum() - fb0.sum()) / max(abs(fb0.sum()), 1e-9) < 1e-3
