"""The port's core (RNG, vectors, camera) against the reference package.

Inputs are made with numpy from a seed and fed to both.  Integer streams
are compared bit for bit.  Float transforms built from arithmetic and sqrt
are bit-equal too: the port rounds sqrt as IEEE float32 and so does JAX
on the CPU, and neither fuses a multiply-add when run op by op.  The ball
transform also uses sin and cos, which no two libraries round alike (JAX
on the CPU calls the C library's sinf/cosf, the port rounds float64
sin/cos once).  Each of those is within 1 ulp of the other library's,
and a ball component multiplies two of them, so the bound there is 4 ulp;
most values are still equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.core import rng as R
from path_tracer_tpu.core.camera import Camera as JCamera
from path_tracer_tpu.engine.integrator import camera_rays as j_camera_rays
from path_tracer_tpu_torch.convert import camera_from_numpy
from path_tracer_tpu_torch.core import rng as TR
from path_tracer_tpu_torch.core.camera import Camera
from path_tracer_tpu_torch.engine.integrator import camera_rays

N = 100_000


@pytest.fixture(scope="module")
def states():
    rs = np.random.RandomState(1234)
    return rs.randint(1, 2 ** 32, size=N, dtype=np.uint64).astype(np.uint32)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def test_xorshift_stream_bit_equal(states):
    js, ts = _j(states), _t(states)
    for _ in range(8):
        js, ts = R.xs32_step(js), TR.xs32_step(ts)
        np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                      ts.numpy())


@pytest.mark.parametrize("fn", ["splitmix32", "u32_to_f01"])
def test_hash_and_u32_to_f01_bit_equal(states, fn):
    j = np.asarray(getattr(R, fn)(_j(states)))
    t = getattr(TR, fn)(_t(states)).numpy()
    if fn == "u32_to_f01":
        np.testing.assert_array_equal(_bits(j), _bits(t))
    else:
        np.testing.assert_array_equal(j.astype(np.int64), t)


def test_seed_perf_bit_equal():
    rs = np.random.RandomState(7)
    pix = rs.randint(0, 480_000, size=N).astype(np.uint32)
    smp = rs.randint(0, 500, size=N).astype(np.uint32)
    for base in (0, 1, 0xDEADBEEF):
        j = np.asarray(R.seed_perf(_j(pix), _j(smp), base)).astype(np.int64)
        t = TR.seed_perf(_t(pix), _t(smp), base).numpy()
        np.testing.assert_array_equal(j, t)
    # the xorshift fixed point 0 is replaced by INITIAL_STATE
    zero = torch.zeros(1, dtype=torch.int64)
    assert int(TR.splitmix32(zero)) != 0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["next_f01", "next_unit_vec",
                                  "next_in_unit_disk", "next_in_unit_ball"])
def test_transforms(states, name, masked):
    mask = (np.arange(N) % 3) != 0 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    js, jv = getattr(R, name)(_j(states), jm)
    ts, tv = getattr(TR, name)(_t(states), tm)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                  ts.numpy())
    jv = jv if isinstance(jv, tuple) else (jv,)
    tv = tv if isinstance(tv, tuple) else (tv,)
    for a, b in zip(jv, tv):
        a, b = np.asarray(a), b.numpy()
        if name == "next_in_unit_ball":
            assert _ulps(a, b).max() <= 4
            assert (_bits(a) == _bits(b)).mean() > 0.95
        else:
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_camera_rays_bit_equal_on_converted_camera():
    jcam = JCamera.create((13, 3, 3), (0, -1, 0), (0, 1, 0), 40.0,
                          800 / 600, 0.04, 13.7, 0.0, 1.0)
    cam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam))
    rs = np.random.RandomState(5)
    pix = rs.randint(0, 800 * 600, size=N).astype(np.uint32)
    seeds = np.asarray(R.seed_perf(_j(pix), _j(np.zeros(N, np.uint32))))
    jr, jo, jd, jt = j_camera_rays(jcam, 800, 600, _j(pix), _j(seeds))
    tr, to, td, tt = camera_rays(cam, 800, 600, _t(pix), _t(seeds))
    np.testing.assert_array_equal(np.asarray(jr).astype(np.int64), tr.numpy())
    for a, b in zip((*jo, *jd, jt), (*to, *td, tt)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_camera_create_close_to_reference():
    """Camera.create itself may round an ulp apart (tan differs between
    libraries); that is why the tests carry the camera across."""
    args = ((13, 3, 3), (0, -1, 0), (0, 1, 0), 40.0, 800 / 600, 0.04, 13.7,
            0.0, 1.0)
    jcam, cam = JCamera.create(*args), Camera.create(*args)
    for jf, tf in zip(jcam, cam):
        jl = jf if isinstance(jf, tuple) else (jf,)
        tl = tf if isinstance(tf, tuple) else (tf,)
        for a, b in zip(jl, tl):
            assert _ulps(a, b.numpy()).max() <= 4


def test_frsqrt_pins_the_reciprocal_square_root():
    """`vec.frsqrt` (both replays' 1/|d|) is an IEEE divide of the
    correctly rounded sqrt: on the CPU it equals torch's rsqrt bit for bit
    over six decades, so pinning it for the card changes no CPU result of
    the port; the reference's `jax.lax.rsqrt` on the CPU is an
    approximation within 2 ulp of it (measured: a third of the values
    differ, by at most 2 ulp)."""
    from path_tracer_tpu_torch.core.vec import frsqrt
    x = np.random.RandomState(5).uniform(-3.0, 3.0, N)
    x = (10.0 ** x).astype(np.float32)
    got = frsqrt(torch.from_numpy(x)).numpy().view(np.int32)
    np.testing.assert_array_equal(
        got, torch.rsqrt(torch.from_numpy(x)).numpy().view(np.int32))
    ref = np.asarray(jax.lax.rsqrt(jnp.asarray(x))).view(np.int32)
    assert np.abs(got.astype(np.int64) - ref).max() <= 2
