"""The port's pixel-pinned gradient route (`diff.pallas_vjp`) and its
entry point `make_render_grad`, against the reference's, on the CPU.

Against the reference (one module-scoped fixture): the final scene at
16x8, 2 spp, depth 4 on the canonical grid (tests/test_pallas_vjp.py's
final-scene config), recorded by the reference's `record_forward` (its
kernel in interpret mode) and by the port's (the kernel's plain
version).  The reference's record, replay and `jax.vjp` are read from the
golden tests/golden/jax_ref/torch_pallas_vjp.npz, which
tools/make_jax_goldens.py records from the frozen package at these
inputs.  Tolerances, and why:
* `win` and `texel`: equal on >= 99.9% of entries, the knife-edge flips
  test_torch_record.py bounds (XLA's CPU compiler contracts a*b+c into
  FMA, the port rounds every op);
* the recorded directions and t, on lanes whose win agrees at every
  bounce: test_torch_bounce.py's one-bounce bounds (within 2e-3
  relative, magnitudes floored at 1, and >= 85% within 4 ulp), held on
  >= 99.5% of entries with every entry within 5e-2, as
  test_torch_record.py holds them along a path: the one-rounding
  differences compound bounce after bounce;
* radiance on those lanes: within 1e-5 on >= 99.5% of entries, and every
  entry within the recorded directions' 2e-3 relative (+ 1e-5): the sky
  term reads the last direction (measured: 3 of 765 entries past 1e-5,
  the largest 2.1e-5, 2.9e-4 relative);
* `replay_radiance` on the reference's own residuals (converted to
  torch): values within 1e-5 relative (atol 1e-7), and the autograd
  gradient within 1e-4 relative L2 of `jax.vjp` of the reference's
  replay, leaf by leaf, for a cotangent drawn from a seed (leaves with a
  negligible norm fall under an absolute 1e-7).  The reference replay
  runs op by op (not jitted), so no FMA contraction separates the two;
* `_scan_maps`: equal, on scenes with inactive (padding) rows.

On the port alone: tests/test_pallas_vjp.py's seven contracts at its
12x12, 4 spp, depth 4 scenes, `make_render_grad(queued=False)` against
the port's `trace(differentiable=True)` (the same estimator) and central
finite differences of the pinned forward, at that file's tolerances; the
canonical-grid check; `queued=True` bit-equal to `render_grad_fb`; the
pinned and queued forwards inside tests/test_wq.py's envelope; and
`render_grad_fn` on permuted and arbitrary lists.  The tests that run the
queued route take 2 spp (its CPU schedule dominates the file's time).
"""
import jax
import numpy as np
import pytest
import torch

from path_tracer_tpu.diff import pallas_vjp as JV
from path_tracer_tpu.diff import params as JP
from path_tracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from path_tracer_tpu.scene.presets import build_final_scene
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.core import rng as TR
from path_tracer_tpu_torch.core.camera import Camera
from path_tracer_tpu_torch.diff import params as TP
from path_tracer_tpu_torch.diff import pallas_vjp as TV
from path_tracer_tpu_torch.diff import queued_vjp as TQ
from path_tracer_tpu_torch.engine.integrator import camera_rays, trace
from path_tracer_tpu_torch.scene import presets as TPR
from path_tracer_tpu_torch.scene.builder import SceneBuilder
from tools import make_jax_goldens as golden

FW, FH, FSPP, FDEPTH = 16, 8, 2, 4          # the final-scene config
CFG = dict(max_depth=FDEPTH, attenuate=True, t_min=1e-3, seed=0)
FN = FW * FH


def _grid(n, spp, p0=0, s0=0):
    return (torch.arange(n).repeat(spp).float() + p0,
            torch.arange(spp).repeat_interleave(n).float() + s0)


def _named_leaves(tree, prefix=()):
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", ("scene", "camera"))
        for name, kid in zip(names, tree):
            yield from _named_leaves(kid, prefix + (name,))
    elif tree is not None:
        yield ".".join(prefix), tree


@pytest.fixture(scope="module")
def ref():
    js, jc = build_final_scene(1.5)
    g = golden.load("torch_pallas_vjp", dict(
        width=FW, height=FH, spp=FSPP, aspect=1.5, tile_rows=8,
        cotangent_seed=8, **CFG))
    res = golden.unflatten(g, "res", JV.Residuals(*[0] * 6))
    sb = JSceneBuilder()         # three spheres in a class padded to 8
    for i in range(3):
        sb.add_sphere((i, 0, -1), 0.5, sb.lambertian((0.5, 0.5, 0.5)))
    jsmall = sb.build()
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    scene = scene_from_numpy(np_(js), "cpu")
    cam = camera_from_numpy(np_(jc))
    port_rad, port_res = TV.record_forward(
        scene, cam, FW, FH, *_grid(FN, FSPP), tile_rows=8, device="cpu",
        **CFG)
    return dict(
        scene=scene, cam=cam, rad=g["rad"],
        res=TV.Residuals(*(torch.from_numpy(np.asarray(x).astype(
            np.int32 if name == "texel" else np.float32))
            for name, x in zip(JV.Residuals._fields, res))),
        val=g["val"], ct=g["ct"],
        grads=golden.unflatten(g, "grads", JP.partition((js, jc))[0]),
        maps=[np.asarray(m) for m in JV._scan_maps(js)],
        small=scene_from_numpy(np_(jsmall), "cpu"),
        small_maps=[np.asarray(m) for m in JV._scan_maps(jsmall)],
        port_rad=port_rad, port_res=port_res)


# ---- record_forward against the reference ----------------------------------

def _same_lanes(ref):
    """Lanes whose win agrees with the reference's at every bounce."""
    return (ref["port_res"].win.numpy() == ref["res"].win.numpy()).all(
        axis=0).reshape(-1)


@pytest.mark.parametrize("plane", ["win", "texel"])
def test_record_integer_planes_match(ref, plane):
    x = getattr(ref["res"], plane).numpy()
    y = getattr(ref["port_res"], plane).numpy()
    assert x.shape == y.shape == (FDEPTH, 8, 128)
    assert (x == y).mean() >= 0.999, (x == y).mean()


@pytest.mark.parametrize("plane", ["dx", "dy", "dz", "t"])
def test_record_float_planes_match(ref, plane):
    same = _same_lanes(ref)
    assert same.mean() >= 0.99
    x = getattr(ref["res"], plane).numpy().reshape(FDEPTH, -1)[:, same]
    y = getattr(ref["port_res"], plane).numpy().reshape(FDEPTH, -1)[:, same]
    x, y = x.astype(np.float64), y.astype(np.float64)
    rel = np.abs(x - y) / np.maximum(np.maximum(np.abs(x), np.abs(y)), 1.0)
    assert rel.max() <= 5e-2, rel.max()
    assert (rel <= 2e-3).mean() >= 0.995, (rel <= 2e-3).mean()
    xi = x.astype(np.float32).view(np.int32).astype(np.int64)
    yi = y.astype(np.float32).view(np.int32).astype(np.int64)
    assert (np.abs(xi - yi) <= 4).mean() >= 0.85


def test_record_radiance_matches(ref):
    same = _same_lanes(ref)[:FN * FSPP]
    rad = ref["port_rad"].numpy()
    assert rad.shape == (FN * FSPP, 3) and np.isfinite(rad).all()
    err = np.abs(rad[same] - ref["rad"][same])
    assert (err <= 1e-5).mean() >= 0.995, (err <= 1e-5).mean()
    np.testing.assert_allclose(rad[same], ref["rad"][same], rtol=2e-3,
                               atol=1e-5)
    assert float(np.abs(rad).sum()) > 0


# ---- replay_radiance on the reference's residuals --------------------------

def test_replay_values_match_reference(ref):
    with torch.no_grad():
        val = TV.replay_radiance(ref["scene"], ref["cam"], ref["res"],
                                 *_grid(FN, FSPP), width=FW, height=FH,
                                 **CFG).numpy()
    np.testing.assert_allclose(val, ref["val"], rtol=1e-5, atol=1e-7)


def test_replay_gradient_matches_jax_vjp(ref):
    params, static = TP.partition((ref["scene"], ref["cam"]))
    xs = [x.clone().requires_grad_(True) for x in TP.leaves(params)]
    scene, cam = TP.combine(TP.with_leaves(params, xs), static)
    val = TV.replay_radiance(scene, cam, ref["res"], *_grid(FN, FSPP),
                             width=FW, height=FH, **CFG)
    gs = torch.autograd.grad(val, xs, torch.from_numpy(ref["ct"]),
                             allow_unused=True)
    port = dict(_named_leaves(TP.with_leaves(params, [
        torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)])))
    jg = ref["grads"]
    ref_tree = (scene_from_numpy(jg[0], "cpu"), camera_from_numpy(jg[1]))
    checked = 0
    for name, r in _named_leaves(ref_tree):
        p = port[name].double()
        r = r.double()
        assert torch.isfinite(p).all(), name
        err = float((p - r).norm())
        assert err <= 1e-4 * float(r.norm()) + 1e-7, (name, err,
                                                      float(r.norm()))
        checked += float(r.norm()) > 1e-7
    assert checked >= 10


@pytest.mark.parametrize("which", ["final", "small"])
def test_scan_maps_match_reference(ref, which):
    scene = ref["scene"] if which == "final" else ref["small"]
    want = ref["maps"] if which == "final" else ref["small_maps"]
    assert any(not bool(c.active.all()) for c in (
        scene.spheres, scene.rects, scene.triangles))      # padding rows
    for got, w in zip(TV._scan_maps(scene), want):
        np.testing.assert_array_equal(got.numpy(), w.astype(np.int64))


# ---- tests/test_pallas_vjp.py's contracts, on the port ---------------------

W = H = 12
SPP, DEPTH = 4, 4
N = W * H


def _cam():
    return Camera.create((0, 0.2, 0.6), (0, 0, -1), (0, 1, 0), 60.0, 1.0,
                         0.0, 1.6)


def _three_spheres():
    sb = SceneBuilder()
    sb.add_sphere((0, -100.5, -1), 100.0, sb.lambertian((0.6, 0.6, 0.6)))
    sb.add_sphere((0, 0, -1), 0.5, sb.lambertian((0.5, 0.2, 0.3)))
    sb.add_sphere((0, 1.2, -1), 0.3, sb.light((4.0, 4.0, 4.0)))
    return sb.build(device="cpu")


def _metal():
    sb = SceneBuilder()
    sb.add_sphere((0, 0, -1), 0.5, sb.metal((0.9, 0.9, 0.9), 0.2))
    return sb.build(device="cpu")


def _glass():
    sb = SceneBuilder()
    sb.add_sphere((0, -100.5, -1), 100.0, sb.lambertian((0.6, 0.6, 0.6)))
    sb.add_sphere((0, 0, -1), 0.5, sb.dielectric(1.5, (1.0, 1.0, 1.0)))
    return sb.build(device="cpu")


def _smoke():
    sb = SceneBuilder()
    sb.add_sphere((0, -100.5, -1), 100.0, sb.lambertian((0.6, 0.6, 0.6)))
    sb.add_constant_medium(("sphere", (0, 0, -1), 0.5), 1.5,
                           (0.8, 0.8, 0.8))
    return sb.build(device="cpu")


def _put(t, idx, v):
    return t.index_put((torch.tensor([idx]),), v.reshape(1))


def _set_c1(s, idx, v, comps):
    c1 = s.textures.c1
    c1 = type(c1)(*(_put(c, idx, v) if n in comps else c
                    for n, c in zip(c1._fields, c1)))
    return s._replace(textures=s.textures._replace(c1=c1))


def _pinned_loss():
    f = TV.make_render_grad(W, H, *_grid(N, SPP), max_depth=DEPTH,
                            attenuate=True, queued=False, device="cpu")
    return lambda scene, cam: f(scene, cam).mean()


def _trace_loss(scene, cam):
    pix, samp = (x.long() for x in _grid(N, SPP))
    state, o, d, t = camera_rays(cam, W, H, pix, TR.seed_perf(pix, samp, 0))
    _, rad = trace(scene, o, d, t, state, DEPTH, attenuate_emission=True,
                   differentiable=True)
    return (rad.x.mean() + rad.y.mean() + rad.z.mean()) / 3.0


CASES = {
    # name: (scene, setter, x0, (rtol, atol) against trace or None,
    #        (rtol, atol) against finite differences or None, sign)
    "albedo": (_three_spheres, lambda s, v: _set_c1(s, 1, v, "x"), 0.5,
               (1e-3, 0.0), (2e-2, 0.0), 1),
    "light": (_three_spheres, lambda s, v: _set_c1(
        s, s.textures.c1.x.shape[0] - 1, v, "xyz"), 4.0, (1e-3, 0.0),
        (2e-2, 0.0), 1),
    "radius": (_three_spheres, lambda s, v: s._replace(
        spheres=s.spheres._replace(radius=_put(s.spheres.radius, 1, v))),
        0.5, (5e-3, 1e-5), None, 0),
    "metal_fuzz": (_metal, lambda s, v: s._replace(
        materials=s.materials._replace(param=_put(s.materials.param, 0,
                                                  v))),
        0.2, None, (0.15, 2e-4), 0),
    "dielectric_ior": (_glass, lambda s, v: s._replace(
        materials=s.materials._replace(param=_put(s.materials.param, 1,
                                                  v))),
        1.5, (2e-2, 1e-5), None, 0),
    "medium_density": (_smoke, lambda s, v: s._replace(
        media=s.media._replace(neg_inv_density=_put(
            s.media.neg_inv_density, 0, v))),
        -1.0 / 1.5, None, None, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pinned_gradient_contracts(case):
    build, setter, x0, vs_trace, vs_fd, sign = CASES[case]
    base, cam = build(), _cam()
    if case == "medium_density":
        x0 = float(base.media.neg_inv_density[0])
    loss = _pinned_loss()
    x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
    g = float(torch.autograd.grad(loss(setter(base, x), cam), x)[0])
    assert np.isfinite(g)
    if sign:
        assert g * sign > 0
    if vs_trace is not None:
        xj = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
        gj = float(torch.autograd.grad(_trace_loss(setter(base, xj), cam),
                                       xj)[0])
        np.testing.assert_allclose(g, gj, rtol=vs_trace[0],
                                   atol=vs_trace[1])
    if vs_fd is not None:
        eps = 1e-2
        with torch.no_grad():
            fd = (float(loss(setter(base, torch.tensor(x0 + eps)), cam))
                  - float(loss(setter(base, torch.tensor(x0 - eps)), cam))
                  ) / (2 * eps)
        np.testing.assert_allclose(g, fd, rtol=vs_fd[0], atol=vs_fd[1])


def _leaf_grads(f, scene, cam):
    params, static = TP.partition((scene, cam))
    xs = [x.detach().requires_grad_(True) for x in TP.leaves(params)]
    out = f(*TP.combine(TP.with_leaves(params, xs), static))
    return out, torch.autograd.grad(out.mean(), xs, allow_unused=True)


@pytest.mark.parametrize("which", ["camera", "final_scene"])
def test_pinned_gradients_finite_on_every_leaf(ref, which):
    """The camera's leaves (the port's Camera.create takes no tensor vfov,
    so the camera is differentiated leaf by leaf), and every leaf of the
    final scene: finite, and not all zero."""
    if which == "camera":
        f = TV.make_render_grad(W, H, *_grid(N, SPP), max_depth=DEPTH,
                                queued=False, device="cpu")
        scene, cam = _three_spheres(), _cam()
    else:
        f = TV.make_render_grad(FW, FH, *_grid(FN, FSPP), max_depth=FDEPTH,
                                queued=False, device="cpu")
        scene, cam = ref["scene"], ref["cam"]
    _, gs = _leaf_grads(f, scene, cam)
    gs = [g for g in gs if g is not None]
    n_cam = len(TP.leaves(TP.partition(cam)[0]))
    if which == "camera":
        gs = gs[-n_cam:]
    assert gs and all(bool(torch.isfinite(g).all()) for g in gs)
    assert sum(float(g.abs().sum()) for g in gs) > 0.0


# ---- make_render_grad and render_grad_fn -----------------------------------

@pytest.mark.parametrize("pix,samp", [
    (torch.arange(N).repeat(SPP).flip(0).float(),
     torch.arange(SPP).repeat_interleave(N).float()),      # pixels reversed
    (torch.arange(N).repeat(SPP).float(),
     torch.arange(SPP).repeat(N).float()),                 # sample-major
    (torch.arange(N).repeat(SPP).float(),
     (2 * torch.arange(SPP)).repeat_interleave(N).float())])  # gapped samples
def test_make_render_grad_refuses_a_non_canonical_list(pix, samp):
    with pytest.raises(ValueError, match="canonical"):
        TV.make_render_grad(W, H, pix, samp, device="cpu")


def test_queued_route_is_render_grad_fb():
    p0, s0 = 7, 3
    scene, cam = _three_spheres(), _cam()
    n = N - 7
    f = TV.make_render_grad(W, H, *_grid(n, 2, p0, s0), max_depth=DEPTH,
                            device="cpu")
    fq = TQ.render_grad_fb(W, H, n, 2, max_depth=DEPTH, device="cpu")
    with torch.no_grad():
        a, b = f(scene, cam), fq(scene, cam, p0, s0)
    np.testing.assert_array_equal(a.numpy().view(np.int32),
                                  b.numpy().view(np.int32))


def test_queued_forward_inside_the_pinned_envelope():
    scene, cam = TPR.build_final_scene(W / H, device="cpu")
    kw = dict(max_depth=DEPTH, device="cpu")
    with torch.no_grad():
        imgs = [TV.make_render_grad(W, H, *_grid(N, 2), queued=q, **kw)(
            scene, cam).numpy() for q in (False, True)]
    assert all(np.isfinite(x).all() and x.shape == (N, 3) for x in imgs)
    d = np.abs(imgs[0] - imgs[1]).max(axis=-1)
    assert float((d > 5e-3).mean()) <= 0.03, float(d.max())


def test_render_grad_fn_follows_the_list():
    """A permuted list gives the permuted radiance, bit for bit (each lane
    traces its own sample), and pix and samp get zero gradients."""
    scene, cam = _three_spheres(), _cam()
    g = TV.render_grad_fn(W, H, max_depth=DEPTH, device="cpu")
    pix, samp = _grid(N, SPP)
    perm = torch.from_numpy(np.random.RandomState(3).permutation(N * SPP))
    with torch.no_grad():
        a = g(scene, cam, pix, samp)
        b = g(scene, cam, pix[perm], samp[perm])
    np.testing.assert_array_equal(b.numpy(), a.numpy()[perm.numpy()])
    pix_r, samp_r = (x[perm[:100]].clone().requires_grad_(True)
                     for x in (pix, samp))
    params, static = TP.partition((scene, cam))
    xs = [x.detach().requires_grad_(True) for x in TP.leaves(params)]
    rad = g(*TP.combine(TP.with_leaves(params, xs), static), pix_r, samp_r)
    gp, gsm, *gx = torch.autograd.grad(rad.sum(), [pix_r, samp_r, *xs])
    assert float(gp.abs().sum()) == float(gsm.abs().sum()) == 0.0
    assert gp.shape == pix_r.shape and gsm.shape == samp_r.shape
    assert sum(float(x.abs().sum()) for x in gx) > 0


def _box_lanes(scene, res):
    """Lanes whose recorded path hits a rect whose scan id several sides
    share (a box, box.hpp:20-25)."""
    r = scene.rects
    box = torch.unique(r.scan[r.active & (r.sub > 0)]).long()
    enc = torch.clamp(res.win - 1.0, min=0.0)
    rem = enc - torch.floor(enc / 4096.0) * 4096.0
    cls = torch.floor(rem / 1024.0)
    scan = (rem - cls * 1024.0).long()
    hit = (res.win > 0) & (cls == 1.0) & torch.isin(scan, box)
    return hit.any(0).reshape(-1)


def test_pinned_replay_reconstructs_the_record_off_boxes(ref):
    """The reference's replay names a rect by its scan id, which a box's
    six sides share, so on a box it replays the side its scan map holds
    (the last one), whichever side the path hit; the port keeps that.
    Off boxes the replay reconstructs the recorded radiance (1e-5); the
    final scene's paths that hit a box are the only ones allowed to
    differ."""
    with torch.no_grad():
        val = TV.replay_radiance(ref["scene"], ref["cam"], ref["port_res"],
                                 *_grid(FN, FSPP), width=FW, height=FH,
                                 **CFG).numpy()
    rad = ref["port_rad"].numpy()
    box = _box_lanes(ref["scene"], ref["port_res"]).numpy()[:FN * FSPP]
    assert 0 < box.sum() < 0.1 * box.size
    np.testing.assert_allclose(val[~box], rad[~box], rtol=0, atol=1e-5)


@pytest.mark.parametrize("build", [_glass, _smoke], ids=["glass", "smoke"])
def test_pinned_and_queued_gradients_agree(build):
    """On scenes without boxes the two routes trace the same paths and
    replay the same estimator: every leaf's gradient within 1e-4 relative
    L2 (measured <= 9e-7 on the CPU; the routes associate a few products
    differently)."""
    scene, cam = build(), _cam()
    out = [_leaf_grads(TV.make_render_grad(
        W, H, *_grid(N, 2), max_depth=DEPTH, queued=q, device="cpu"),
        scene, cam) for q in (False, True)]
    (img_p, g_p), (img_q, g_q) = out
    np.testing.assert_allclose(img_p.detach().numpy(),
                               img_q.detach().numpy(), rtol=0, atol=1e-6)
    for a, b in zip(g_p, g_q):
        a, b = a.double(), b.double()
        assert torch.isfinite(a).all()
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-9
