"""Record the JAX references that the port's slowest test fixtures compare
with, as goldens under tests/golden/jax_ref/.

The JAX package (`path_tracer_tpu/`) is frozen, so at a fixture's fixed
inputs its jitted references (gradients, records, renders, train steps)
are constants.  `compute(name)` calls the package with exactly one
fixture's inputs, `INPUTS[name]`, and returns what the fixture took from
it, keyed by leaf name.  `write` stores that as one `.npz` a fixture,
with the jax and jaxlib versions and the inputs; the fixture reads it
back with `load`, which refuses a golden recorded for other inputs or by
other versions than the installed ones.  Every input a function reads comes from
the JAX package or from its `INPUTS`, never from the port, so a change to
the port cannot make a golden stale.  tests/test_jax_goldens.py (the
`slow` lane) recomputes every golden here and holds it equal to its file.

Run from the repository's root, on the CPU (a few minutes for all):

    python tools/make_jax_goldens.py              # every golden
    python tools/make_jax_goldens.py torch_grad   # the named ones
"""
import json
import os
import sys
from contextlib import contextmanager

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden", "jax_ref")

# name -> the fixture's inputs (tests/test_<name>.py)
INPUTS = {
    "torch_grad": dict(width=16, height=12, spp=2, max_depth=4,
                       fetch_mode="high",
                       keywords={"defaults": dict(attenuate=True),
                                 "seed3_unattenuated": dict(
                                     seed=3, attenuate=False)}),
    "torch_record": dict(width=16, height=12, spp=2, max_depth=4,
                         attenuate=True),
    "torch_pallas_vjp": dict(width=16, height=8, spp=2, max_depth=4,
                             attenuate=True, t_min=1e-3, seed=0, aspect=1.5,
                             tile_rows=8, cotangent_seed=8),
    "torch_edge": dict(grad=dict(width=12, height=12, spp=4, max_depth=4,
                                 albedo=0.5, light=4.0),
                       edge=dict(width=40, height=40, n_edge=192,
                                 spp_edge=48, max_depth=4, seed=5)),
    "torch_cli": dict(scene="cornell_box", width=16, height=16, spp=4,
                      max_depth=6, tile_rows=8, window=3),
    "torch_wq": dict(scene="final_scene", aspect=1.5, width=24, height=16,
                     spp=4, max_depth=8, tile_rows=4, window=3),
    "torch_wq_drain": dict(scene="final_scene", aspect=1.5, width=48,
                           height=32, spp=1, max_depth=6, tile_rows=8,
                           window=2),
}
# tests/test_sharding.py's train step on the three-sphere scene, with
# target the reference's work-queue render at `target_spp`
_STEP = dict(scene="three_spheres", width=16, height=8, max_depth=3,
             local_spp=2, lr=0.5, perturb_color_x=0.2, target_spp=4,
             fetch_mode="high")
INPUTS["torch_train"] = dict(_STEP, mesh=[1, 1])
INPUTS["torch_sharded"] = dict(_STEP, mesh=[2, 1])
INPUTS["torch_sharded_spp"] = dict(_STEP, mesh=[1, 2])


def _jsonable(x):
    return json.loads(json.dumps(x))


# ---- reading and writing ----------------------------------------------------

def path(name):
    return os.path.join(GOLDEN_DIR, name + ".npz")


def flat(prefix, tree):
    """The tree's leaves as numpy arrays, keyed prefix + their path."""
    import jax
    pairs = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + jax.tree_util.keystr(p): np.asarray(x)
            for p, x in pairs}


def unflatten(leaves, prefix, like):
    """A tree shaped like `like` (any leaves) holding the golden's leaves
    stored under `prefix` (what `flat(prefix, ...)` wrote)."""
    import jax
    pairs, treedef = jax.tree_util.tree_flatten_with_path(like)
    return treedef.unflatten([leaves[prefix + jax.tree_util.keystr(p)]
                              for p, _ in pairs])


def versions():
    """The installed jax and jaxlib, which compute the goldens."""
    import jax
    import jaxlib
    return dict(jax=jax.__version__, jaxlib=jaxlib.__version__)


def write(name, leaves):
    meta = dict(name=name, **versions(), inputs=_jsonable(INPUTS[name]))
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    np.savez_compressed(path(name), __meta__=np.array(json.dumps(meta)),
                        **leaves)


def load(name, inputs):
    """The golden's leaves; `inputs` are the fixture's own, and must be
    the ones the golden was recorded for, by the jax and jaxlib installed
    now (another version may compute other values)."""
    with np.load(path(name)) as z:
        meta = json.loads(str(z["__meta__"]))
        leaves = {k: z[k] for k in z.files if k != "__meta__"}
    again = f"run `python tools/make_jax_goldens.py {name}`"
    assert meta["inputs"] == _jsonable(inputs), (
        f"{path(name)} was recorded for {meta['inputs']}, the test asks "
        f"for {_jsonable(inputs)}: {again}")
    recorded = {k: meta.get(k) for k in versions()}
    assert recorded == versions(), (
        f"{path(name)} was recorded by {recorded}, installed are "
        f"{versions()}: {again}")
    return leaves


@contextmanager
def fetch_mode(mode):
    """The reference's FETCH_MODE for the block ("high": an exact f32
    fetch; its default "split3" rounds the table's cotangents to bf16)."""
    from path_tracer_tpu.diff import queued_vjp as JQ
    old, JQ.FETCH_MODE = JQ.FETCH_MODE, mode
    try:
        yield
    finally:
        JQ.FETCH_MODE = old


# ---- the scenes the fixtures share with the reference -----------------------

def grad_scene():
    """tests/test_grad.py's scene (ground, a lambertian ball, a light)
    and camera."""
    from path_tracer_tpu.core.camera import Camera
    from path_tracer_tpu.scene.builder import SceneBuilder
    sb = SceneBuilder()
    sb.add_sphere((0, -100.5, -1), 100.0, sb.lambertian((0.6, 0.6, 0.6)))
    sb.add_sphere((0, 0, -1), 0.5, sb.lambertian((0.5, 0.2, 0.3)))
    sb.add_sphere((0, 1.2, -1), 0.3, sb.light((4.0, 4.0, 4.0)))
    return sb.build(), Camera.create((0, 0.2, 0.6), (0, 0, -1), (0, 1, 0),
                                     60.0, 1.0, 0.0, 1.6)


def edge_scene():
    """tests/test_edge_grad.py's scene (one lambertian sphere over the
    sky) and pinhole camera."""
    from path_tracer_tpu.core.camera import Camera
    from path_tracer_tpu.scene.builder import SceneBuilder
    sb = SceneBuilder()
    sb.add_sphere((0.0, 0.0, -1.0), 0.5, sb.lambertian((0.2, 0.3, 0.6)))
    return sb.build(), Camera.create((0, 0, 1), (0, 0, -1), (0, 1, 0),
                                     60.0, 1.0, 0.0, 2.0)


ALBEDO_ROW, LIGHT_ROW = 1, 2     # grad_scene's ball and light texture rows


# ---- one function a golden --------------------------------------------------

def grad(i):
    """`jax.grad` of mean(render_grad_fb(...)) on the final scene, w.r.t.
    the scene's and the camera's params, once for each keyword set."""
    import jax
    import jax.numpy as jnp
    from path_tracer_tpu.diff import params as JP
    from path_tracer_tpu.diff import queued_vjp as JQ
    from path_tracer_tpu.scene.presets import build_final_scene
    w, h = i["width"], i["height"]
    js, jc = build_final_scene(w / h)
    sp, ss = JP.partition(js)
    cp, cs = JP.partition(jc)
    zero = jnp.float32(0.0)
    out = {}
    with fetch_mode(i["fetch_mode"]):
        for name, kw in i["keywords"].items():
            f = JQ.render_grad_fb(w, h, w * h, i["spp"],
                                  max_depth=i["max_depth"], **kw)

            def loss(sp_, cp_):
                return jnp.mean(f(JP.combine(sp_, ss), JP.combine(cp_, cs),
                                  zero, zero))
            out.update(flat(name, jax.jit(jax.grad(loss, argnums=(0, 1)))(
                sp, cp)))
    return out


def record(i):
    """`record_forward_q` (jitted, its kernel in interpret mode) of the
    final scene with the schedule `render_grad_fb` derives."""
    import jax
    import jax.numpy as jnp
    from path_tracer_tpu.diff import queued_vjp as JQ
    from path_tracer_tpu.scene.presets import build_final_scene
    w, h = i["width"], i["height"]
    js, jc = build_final_scene(w / h)
    cfg = {k: v for k, v in JQ.render_grad_fb(
        w, h, w * h, i["spp"], max_depth=i["max_depth"],
        attenuate=i["attenuate"]).cfg.items()
        if k not in ("width", "height")}
    zero = jnp.float32(0.0)
    fb, rec, ok = jax.jit(lambda s, c: JQ.record_forward_q(
        s, c, w, h, zero, zero, **cfg))(js, jc)
    return dict(flat("rec", rec), fb=np.asarray(fb), ok=np.asarray(ok))


def pinned_record_and_vjp(i):
    """The pinned route's `record_forward` of the final scene on the
    canonical grid (jitted, interpret mode), and `jax.vjp` of
    `replay_radiance` on its residuals for a cotangent drawn from
    `cotangent_seed`."""
    import jax
    import jax.numpy as jnp
    from path_tracer_tpu.diff import pallas_vjp as JV
    from path_tracer_tpu.diff import params as JP
    from path_tracer_tpu.scene.presets import build_final_scene
    w, h, spp = i["width"], i["height"], i["spp"]
    cfg = dict(max_depth=i["max_depth"], attenuate=i["attenuate"],
               t_min=i["t_min"], seed=i["seed"])
    js, jc = build_final_scene(i["aspect"])
    n = w * h
    pix = jnp.tile(jnp.arange(n, dtype=jnp.uint32), spp)
    samp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), n)
    rad, res = jax.jit(lambda s, c: JV.record_forward(
        s, c, w, h, pix, samp, tile_rows=i["tile_rows"], interpret=True,
        **cfg))(js, jc)
    params, static = JP.partition((js, jc))

    def replay(p):
        s, c = JP.combine(p, static)
        return JV.replay_radiance(s, c, res, pix, samp, width=w, height=h,
                                  **cfg)

    val, vjp = jax.vjp(replay, params)
    ct = np.random.RandomState(i["cotangent_seed"]).standard_normal(
        val.shape).astype(np.float32)
    (grads,) = vjp(jnp.asarray(ct))
    return dict(flat("res", res), **flat("grads", grads), rad=np.asarray(rad),
                val=np.asarray(val), ct=ct)


def edge(inputs):
    """`jax.grad` of the mean radiance of `trace(differentiable=True)` on
    grad_scene w.r.t. the ball's albedo and the light's emission, and
    `sphere_silhouette_grad` on edge_scene."""
    import jax
    import jax.numpy as jnp
    from path_tracer_tpu.core import rng as JR
    from path_tracer_tpu.diff.edge import sphere_silhouette_grad
    from path_tracer_tpu.engine import integrator as JI
    i, e = inputs["grad"], inputs["edge"]
    w, h, spp = i["width"], i["height"], i["spp"]
    gs, gc = grad_scene()

    def loss(albedo, light):
        n = w * h
        pix = jnp.tile(jnp.arange(n, dtype=jnp.uint32), spp)
        samp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), n)
        state, o, d, t = JI.camera_rays(gc, w, h, pix,
                                        JR.seed_perf(pix, samp, 0))
        c1 = gs.textures.c1
        c1 = type(c1)(c1.x.at[ALBEDO_ROW].set(albedo).at[LIGHT_ROW].set(
            light), c1.y.at[LIGHT_ROW].set(light),
            c1.z.at[LIGHT_ROW].set(light))
        scene = gs._replace(textures=gs.textures._replace(c1=c1))
        _, rad = JI.trace(scene, o, d, t, state, i["max_depth"],
                          attenuate_emission=True, differentiable=True)
        return (jnp.mean(rad.x) + jnp.mean(rad.y) + jnp.mean(rad.z)) / 3.0

    g_alb, g_light = jax.grad(loss, argnums=(0, 1))(
        jnp.float32(i["albedo"]), jnp.float32(i["light"]))
    es, ec = edge_scene()
    ew, eh = e["width"], e["height"]
    ct = jnp.full((eh, ew, 3), 1.0 / (ew * eh * 3), jnp.float32)
    eg = sphere_silhouette_grad(es, ec, ew, eh, 0, ct, n_edge=e["n_edge"],
                                spp_edge=e["spp_edge"],
                                max_depth=e["max_depth"], seed=e["seed"])
    return dict(g_albedo=np.asarray(g_alb), g_light=np.asarray(g_light),
                center=np.stack([np.asarray(c) for c in eg.center]),
                radius=np.asarray(eg.radius))


def render(i):
    """The work-queue render (interpret mode) of i["scene"], a preset or
    the final scene at `aspect`, with its traced segments, bounce
    iterations and lane steps."""
    from path_tracer_tpu.engine import wq as JWQ
    from path_tracer_tpu.scene.presets import PRESETS, build_final_scene
    js, jc = (build_final_scene(i["aspect"]) if i["scene"] == "final_scene"
              else PRESETS[i["scene"]].build())
    img, segs, iters, lanes = JWQ.render_wq(
        js, jc, i["width"], i["height"], i["spp"], max_depth=i["max_depth"],
        tile_rows=i["tile_rows"], window=i["window"], return_stats=True)
    return dict(img=np.asarray(img), segs=np.asarray(segs),
                iters=np.asarray(iters), lanes=np.asarray(lanes))


def perturb(params, add):
    """The train steps' start: `params` (a scene's and a camera's, JAX's
    or the port's) with the material colours' x moved by `add`."""
    scene_p, cam_p = params
    c = scene_p.materials.color
    return (scene_p._replace(materials=scene_p.materials._replace(
        color=type(c)(c.x + add, c.y, c.z))), cam_p)


def train_step(i):
    """The reference's train step (`parallel.mesh.make_train_step`, first
    call) on a mesh of i["mesh"] (n_tiles, n_spp) virtual devices, SGD on
    the material colours only, from the params with the colours' x
    perturbed; the target is the reference's work-queue render of the
    unperturbed scene."""
    import jax
    import jax.numpy as jnp
    from path_tracer_tpu.engine import wq as JWQ
    from path_tracer_tpu.parallel import mesh as JM
    from path_tracer_tpu.scene.presets import PRESETS
    w, h, depth = i["width"], i["height"], i["max_depth"]
    js, jc = PRESETS[i["scene"]].build()
    target = np.asarray(JWQ.render_wq(js, jc, w, h, i["target_spp"],
                                      max_depth=depth)).reshape(w * h, 3)
    jparams, (js_s, jc_s) = JM.scene_camera_params(js, jc)
    jparams = perturb(jparams, i["perturb_color_x"])
    n_tiles, n_spp = i["mesh"]
    mesh = JM.make_mesh(n_tiles, n_spp,
                        devices=jax.devices()[:n_tiles * n_spp])

    def only_material_colors(grads):
        zs, zc = jax.tree_util.tree_map(
            lambda g: jnp.zeros_like(g) if g is not None else None, grads,
            is_leaf=lambda x: x is None)
        return (zs._replace(materials=zs.materials._replace(
            color=grads[0].materials.color)), zc)

    with fetch_mode(i["fetch_mode"]):
        step = JM.make_train_step(js_s, jc_s, w, h, i["local_spp"], depth,
                                  mesh, lr=i["lr"],
                                  grad_filter=only_material_colors)
        new, loss = step(jparams, jnp.asarray(target),
                         jnp.arange(w * h, dtype=jnp.uint32))
    return dict(flat("new", new), target=target, loss=np.asarray(loss))


# name -> the function that computes it from INPUTS[name]
RECIPES = dict(torch_grad=grad, torch_record=record,
               torch_pallas_vjp=pinned_record_and_vjp, torch_edge=edge,
               torch_cli=render, torch_wq=render, torch_wq_drain=render,
               torch_train=train_step, torch_sharded=train_step,
               torch_sharded_spp=train_step)


def compute(name):
    """The golden `name` as the JAX package computes it now."""
    return RECIPES[name](INPUTS[name])


def main(argv):
    names = argv or list(RECIPES)
    for name in names:
        write(name, compute(name))
        print(f"{path(name)}: {os.path.getsize(path(name))} bytes")


if __name__ == "__main__":
    # the tests' JAX setting (tests/conftest.py): the CPU, with 8 virtual
    # devices for the sharded steps' meshes
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")
    sys.path.insert(0, ROOT)
    main(sys.argv[1:])
