"""The port's oracle scatter (`engine.scatter`, with `scene.textures`)
against the reference package's, on the CPU.

tests/test_scatter.py's five materials, plus a checker and an image
texture, on seed-made hit records: random materials, unit normals, front
faces, (u, v), hit points and streams, with some lanes masked off.
`did_scatter` and the RNG state must be equal (each material's draw
count, the dielectric's conditional draw included).  Direction,
attenuation and emission must be within 4 ulp on >= 99% of the live
lanes and within 1e-5 absolute on all of them: the reference's float32
sin, cos and sqrt are XLA's, the port's libm's in float64 rounded once.
The reference is called once, in the module's fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.core.vec import Vec3 as JVec3
from path_tracer_tpu.engine import intersect as JI
from path_tracer_tpu.engine.scatter import scatter as jscatter
from path_tracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from path_tracer_tpu_torch.convert import scene_from_numpy
from path_tracer_tpu_torch.core.vec import Vec3
from path_tracer_tpu_torch.engine import intersect as TI
from path_tracer_tpu_torch.engine.scatter import _pow5, scatter

N = 1024


def _scene():
    sb = JSceneBuilder()
    sb.lambertian((0.5, 0.4, 0.3))                             # mat 0
    sb.metal((0.8, 0.7, 0.6), 0.2)                             # mat 1
    sb.dielectric(1.5, (1.0, 0.9, 0.9))                        # mat 2
    sb.light((7.0, 6.0, 5.0))                                  # mat 3
    sb.isotropic((0.9, 0.9, 0.9))                              # mat 4
    sb.lambertian(sb.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    img = np.zeros((4, 4, 3), np.uint8)
    img[::2, ::2] = [255, 0, 0]
    img[1::2, 1::2] = [0, 0, 255]
    sb.lambertian(sb.image_texture(img))                       # mat 6
    sb.add_sphere((0, 0, 0), 1.0, 0)  # keep the scene non-empty
    return sb.build()


def _hits(n, seed):
    rs = np.random.RandomState(seed)
    nrm = rs.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    p = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    return dict(mat=rs.randint(0, 7, n).astype(np.int32),
                normal=nrm.astype(np.float32), p=p,
                front=rs.rand(n) < 0.5, u=rs.rand(n).astype(np.float32),
                v=rs.rand(n).astype(np.float32), rd=rd,
                state=rs.randint(1, 2 ** 31, n).astype(np.uint32),
                mask=rs.rand(n) < 0.9)


@pytest.fixture(scope="module")
def both():
    jscene = _scene()
    h = _hits(N, 3)
    jv = lambda a: JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))
    jh = JI.Hit(hit=jnp.ones(N, bool), t=jnp.full((N,), 2.0),
                p=jv(h["p"]), normal=jv(h["normal"]),
                front_face=jnp.asarray(h["front"]), u=jnp.asarray(h["u"]),
                v=jnp.asarray(h["v"]), mat=jnp.asarray(h["mat"]),
                cls=jnp.zeros(N, jnp.int32))
    js, jsc = jscatter(jscene, jh, jv(h["rd"]), jnp.asarray(h["state"]),
                       jnp.asarray(h["mask"]))
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene),
                             "cpu")
    tv = lambda a: Vec3(*(torch.from_numpy(a[:, i].copy())
                          for i in range(3)))
    th = TI.Hit(hit=torch.ones(N, dtype=torch.bool),
                t=torch.full((N,), 2.0), p=tv(h["p"]), normal=tv(h["normal"]),
                front_face=torch.from_numpy(h["front"]),
                u=torch.from_numpy(h["u"]), v=torch.from_numpy(h["v"]),
                mat=torch.from_numpy(h["mat"]),
                cls=torch.zeros(N, dtype=torch.int32))
    ts, tsc = scatter(scene, th, tv(h["rd"]),
                      torch.from_numpy(h["state"].astype(np.int64)),
                      torch.from_numpy(h["mask"]))
    return h, (np.asarray(js), jsc), (ts.numpy(), tsc)


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def test_draws_and_did_scatter_equal(both):
    h, (js, jsc), (ts, tsc) = both
    np.testing.assert_array_equal(ts & 0xFFFFFFFF, js.astype(np.int64))
    np.testing.assert_array_equal(tsc.did_scatter.numpy(),
                                  np.asarray(jsc.did_scatter))
    # masked lanes keep their streams; lights draw nothing; the other
    # materials but the dielectric (no draw at total internal reflection)
    # always draw
    keep = ~h["mask"] | (h["mat"] == 3)
    np.testing.assert_array_equal(ts[keep], h["state"][keep])
    draw = ~keep & (h["mat"] != 2)
    assert (ts[draw] != h["state"][draw]).all()
    diel = ~keep & (h["mat"] == 2)
    assert 0 < (ts[diel] != h["state"][diel]).sum() < diel.sum()


@pytest.mark.parametrize("field", ["direction", "attenuation", "emitted"])
def test_floats_within_ulps(both, field):
    h, (_, jsc), (_, tsc) = both
    live = h["mask"]
    for i in range(3):
        a = np.asarray(getattr(jsc, field)[i])[live]
        b = getattr(tsc, field)[i].numpy()[live]
        assert float((_ulps(a, b) <= 4).mean()) >= 0.99, (field, i)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5,
                                   err_msg=f"{field}[{i}]")


def test_every_material_and_texture_ran(both):
    h, _, (_, tsc) = both
    live = h["mask"]
    assert set(np.unique(h["mat"][live])) == set(range(7))
    att = torch.stack(list(tsc.attenuation), 1).numpy()
    # the checker's two colours and the image's red and blue texels show
    chk = att[live & (h["mat"] == 5)]
    assert np.isclose(chk[:, 0], 0.2).any() and np.isclose(chk[:, 0],
                                                           0.9).any()
    img = att[live & (h["mat"] == 6)]
    assert (img[:, 0] == 1.0).any() or (img[:, 2] == 1.0).any()


def test_pow5_is_the_multiply_chain():
    x = torch.tensor([0.0, 0.3, 0.5, 1.0])
    np.testing.assert_array_equal(_pow5(x).numpy(),
                                  ((x * x) * (x * x) * x).numpy())
