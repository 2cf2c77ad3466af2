"""The port's oracle intersection (`engine.intersect`) against the
reference package's, on the CPU.

The same scene (carried across with `convert`) and the same seed-made rays
go through both `intersect_scene`s.  Integers must be equal: hit, class,
material, front face and the RNG state (the media draws).  Floats (t, p,
normal, u, v) must be within 4 ulp on >= 97% of the lanes that hit, and
within 1e-5 absolute on all of them: the reference's float32 atan2, asin,
sqrt and log are XLA's, the port's libm's in float64 rounded once, an ulp
apart on some lanes, and u = 1 - (phi + pi) / 2pi cancels near u = 0
(8 ulp of a u ~ 0.05 on 1 of 87 tie-table lanes).  Ties: a table of
exact t ties across spheres (the first wins), rects and triangles (the
last wins).  Badouel's triangles agree with Moller-Trumbore away from
edges, as tests/test_intersect.py holds the reference's, and with the
reference's Badouel matrix.  Every reference call is made once, in the
module's fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.core.vec import Vec3 as JVec3
from path_tracer_tpu.engine import intersect as JI
from path_tracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from path_tracer_tpu_torch.convert import scene_from_numpy
from path_tracer_tpu_torch.core.vec import Vec3
from path_tracer_tpu_torch.engine import intersect as TI

N = 512


def _mixed_scene():
    """tests/test_intersect.py's mixed scene: static and moving spheres,
    rects of every axis, a triangle, a box, a sphere and a box medium."""
    sb = JSceneBuilder()
    mat = sb.lambertian((0.5, 0.5, 0.5))
    sb.add_sphere((0, 0, -3), 1.0, mat)
    sb.add_moving_sphere((2.5, 0, -3), (2.5, 1, -3), 0.0, 1.0, 0.7,
                         sb.metal((0.8, 0.8, 0.8), 0.1))
    sb.add_xy_rect(-2, -0.5, -1, 1, -4, sb.lambertian((0.9, 0.1, 0.1)))
    sb.add_xz_rect(-3, 3, -6, -1, -1.5, mat)
    sb.add_yz_rect(-1, 1, -5, -2, -3.5, sb.light((4, 4, 4)))
    sb.add_triangle((-1, -1, -2), (1, -1, -2), (0, 1.5, -2.5),
                    sb.lambertian((0.2, 0.2, 0.9)))
    sb.add_box((1.0, -1.0, -5.0), (2.0, 0.0, -4.0), mat)
    sb.add_constant_medium(("sphere", (-2.0, 0.0, -3.0), 0.8), 2.0,
                           (1.0, 1.0, 1.0))
    sb.add_constant_medium(("box", (-0.5, -0.5, -6.5), (0.5, 0.5, -5.5)),
                           1.5, (0.9, 0.9, 0.9))
    return sb.build()


def _tie_scene():
    """Exact t ties in every class: three equal spheres (the first must
    win), two equal rects and two equal triangles (the last must win),
    each hit head-on by the rays of `_tie_rays`."""
    sb = JSceneBuilder()
    for g in (0.2, 0.5, 0.8):
        sb.add_sphere((0.0, 0.0, -3.0), 1.0, sb.lambertian((g, g, g)))
    for g in (0.3, 0.6):
        sb.add_xy_rect(2.0, 4.0, -1.0, 1.0, -2.0, sb.lambertian((g, g, g)))
    for g in (0.4, 0.7):
        sb.add_triangle((-4.0, -1.0, -2.5), (-2.0, -1.0, -2.5),
                        (-3.0, 1.0, -2.5), sb.lambertian((g, g, g)))
    return sb.build()


def _rays(n, seed, spread=3.0):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    o[:, 2] += 2.0
    target = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    target[:, 2] -= 4.0
    d = (target - o).astype(np.float32)
    t = rs.uniform(0, 1, n).astype(np.float32)
    state = (rs.randint(1, 2 ** 31, n).astype(np.uint64) * 2 + 1) % 2 ** 32
    return o, d, t, state.astype(np.uint32)


def _tie_rays(n, seed):
    """Rays from the origin's neighbourhood towards the tie table's three
    groups, so that each lane meets equal t in one class."""
    rs = np.random.RandomState(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rs.uniform(-0.05, 0.05, (n, 2))
    target = np.stack([rs.choice([-3.0, 0.0, 3.0], n)
                       + rs.uniform(-0.3, 0.3, n),
                       rs.uniform(-0.3, 0.3, n),
                       np.full(n, -3.0)], 1).astype(np.float32)
    d = (target - o).astype(np.float32)
    state = rs.randint(1, 2 ** 31, n).astype(np.uint32)
    return o, d, np.zeros(n, np.float32), state


def _run_both(jscene, o, d, t, state, **kw):
    mask = np.ones(len(t), bool)
    mask[::7] = False                  # dead lanes draw nothing
    jv = lambda a: JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))
    js, jh = JI.intersect_scene(jscene, jv(o), jv(d), jnp.asarray(t),
                                jnp.asarray(state), jnp.asarray(mask), **kw)
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene),
                             "cpu")
    tv = lambda a: Vec3(*(torch.from_numpy(a[:, i].copy())
                          for i in range(3)))
    ts, th = TI.intersect_scene(
        scene, tv(o), tv(d), torch.from_numpy(t),
        torch.from_numpy(state.astype(np.int64)), torch.from_numpy(mask),
        **kw)
    return (np.asarray(js), jh), (ts.numpy(), th)


def _triangle_table():
    rs = np.random.RandomState(7)
    sb = JSceneBuilder()
    m = sb.lambertian((0.5, 0.5, 0.5))
    for _ in range(12):
        v = rs.uniform(-2, 2, (3, 3)).astype(np.float32)
        v[:, 2] -= 4.0
        sb.add_triangle(tuple(v[0]), tuple(v[1]), tuple(v[2]), m)
    o = rs.uniform(-0.5, 0.5, (512, 3)).astype(np.float32)
    d = rs.uniform(-1, 1, (512, 3)).astype(np.float32)
    d[:, 2] -= 1.5
    return sb.build(), o, d


@pytest.fixture(scope="module")
def refs():
    """Every reference call of this file, beside the port's."""
    jscene, o, d = _triangle_table()
    jv = lambda a: JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))
    badouel_ref = np.asarray(JI.triangle_t_matrix_badouel(
        jscene.triangles, jv(o), jv(d), jnp.float32(1e-3), jnp.inf))
    return {"mixed": _run_both(_mixed_scene(), *_rays(N, 0)),
            "exact": _run_both(_mixed_scene(), *_rays(256, 3), exact=True),
            "factorized": _run_both(_mixed_scene(), *_rays(256, 3),
                                    exact=False),
            "ties": _run_both(_tie_scene(), *_tie_rays(256, 1)),
            "badouel": (jscene, o, d, badouel_ref)}


@pytest.fixture
def mixed(refs):
    return refs["mixed"]


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _assert_same_hits(ref, port):
    (js, jh), (ts, th) = ref, port
    np.testing.assert_array_equal(ts & 0xFFFFFFFF, js.astype(np.int64))
    for f in ("hit", "cls", "mat", "front_face"):
        np.testing.assert_array_equal(getattr(th, f).numpy(),
                                      np.asarray(getattr(jh, f)), err_msg=f)
    hit = np.asarray(jh.hit)
    floats = {"t": (jh.t, th.t), "u": (jh.u, th.u), "v": (jh.v, th.v)}
    for i, c in enumerate("xyz"):
        floats["p" + c] = (jh.p[i], th.p[i])
        floats["n" + c] = (jh.normal[i], th.normal[i])
    for name, (a, b) in floats.items():
        a, b = np.asarray(a)[hit], b.numpy()[hit]
        assert float((_ulps(a, b) <= 4).mean()) >= 0.97, name
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=name)


def test_intersect_scene_matches_reference(mixed):
    ref, port = mixed
    _assert_same_hits(ref, port)
    # the scene is hit by most rays, in every class, and media drew
    cls = port[1].cls.numpy()[port[1].hit.numpy()]
    assert set(np.unique(cls)) == {0, 1, 2, 3}


def test_media_draws_only_on_live_lanes(mixed):
    _, (ts, _) = mixed
    _, _, _, state = _rays(N, 0)
    moved = ts != state.astype(np.int64)
    assert not moved[::7].any()        # dead lanes kept their streams
    assert moved.any()


@pytest.mark.parametrize("exact", [True, False])
def test_exact_and_factorized_spheres_match_reference(refs, exact):
    """exact=False takes the factorized sphere kernel on both sides (the
    reference's matrix products, the port's broadcast multiply-adds)."""
    _assert_same_hits(*refs["exact" if exact else "factorized"])


def test_ties_go_the_reference_way(refs):
    ref, port = refs["ties"]
    _assert_same_hits(ref, port)
    hit = port[1].hit.numpy()
    mat = port[1].mat.numpy()[hit]
    cls = port[1].cls.numpy()[hit]
    # spheres: the first of the three equal ones (material 0); rects and
    # triangles: the last of their two (materials 4 and 6)
    assert set(mat[cls == 0]) == {0}
    assert set(mat[cls == 1]) == {4}
    assert set(mat[cls == 2]) == {6}


def test_badouel_matches_moller_trumbore_and_reference(refs):
    jscene, o, d, ref_bd = refs["badouel"]
    tv = lambda a: Vec3(*(torch.from_numpy(a[:, i].copy())
                          for i in range(3)))
    tris = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene),
                            "cpu").triangles
    t_mt = TI.triangle_t_matrix(tris, tv(o), tv(d), 1e-3, np.inf).numpy()
    t_bd = TI.triangle_t_matrix_badouel(tris, tv(o), tv(d), 1e-3,
                                        np.inf).numpy()
    hit_mt, hit_bd = t_mt < 1e30, t_bd < 1e30
    # as tests/test_intersect.py: the two strategies agree away from
    # edge-epsilon regions, and on t where both hit
    assert float((hit_mt == hit_bd).mean()) >= 0.99
    both = hit_mt & hit_bd
    assert both.sum() > 50
    np.testing.assert_allclose(t_bd[both], t_mt[both], rtol=1e-4)
    assert float(((t_bd < 1e30) == (ref_bd < 1e30)).mean()) >= 0.999
    hit_ref = (ref_bd < 1e30) & hit_bd
    assert float((_ulps(t_bd[hit_ref], ref_bd[hit_ref]) <= 4).mean()) >= 0.99
    assert set(TI.TRIANGLE_KERNELS) == set(JI.TRIANGLE_KERNELS)
