"""The reference's vector and RNG helpers in the port (`core.vec`,
`core.rng`) against the reference package's, on seed-made inputs, on the
CPU.

dot, length_squared, reflect, lerp and where are single float32 ops in
the reference's association order: equal bit for bit.  refract and
grad_safe_sqrt take one sqrt, the port's in float64 rounded once: within
1 ulp.  grad_safe_sqrt's gradient is finite (0) at x <= 0, as the double
`where` makes the reference's.  next_vec and seed_parity are integer
streams: equal, pixel 0's all-zero stream (a reference quirk) included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from path_tracer_tpu.core import rng as JR
from path_tracer_tpu.core import vec as JV
from path_tracer_tpu_torch.core import rng as TR
from path_tracer_tpu_torch.core import vec as TV

N = 512


def _vecs(seed, n=N):
    rs = np.random.RandomState(seed)
    return [rs.normal(size=(n, 3)).astype(np.float32) for _ in range(2)]


def _j(a):
    return JV.Vec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _t(a):
    return TV.Vec3(*(torch.from_numpy(a[:, i].copy()) for i in range(3)))


def _eq(jv, tv, ulp=0):
    for a, b in zip(jv, tv):
        a, b = np.asarray(a), b.numpy()
        if ulp == 0:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=ulp * 2 ** -23, atol=1e-30)


def test_vector_helpers_match_the_reference():
    a, b = _vecs(0)
    t = np.random.RandomState(1).rand(N).astype(np.float32)
    mask = t > 0.5
    np.testing.assert_array_equal(TV.dot(_t(a), _t(b)).numpy(),
                                  np.asarray(JV.dot(_j(a), _j(b))))
    np.testing.assert_array_equal(TV.length_squared(_t(a)).numpy(),
                                  np.asarray(JV.length_squared(_j(a))))
    _eq(JV.reflect(_j(a), _j(b)), TV.reflect(_t(a), _t(b)))
    _eq(JV.lerp(_j(a), _j(b), jnp.asarray(t)),
        TV.lerp(_t(a), _t(b), torch.from_numpy(t)))
    _eq(JV.where(jnp.asarray(mask), _j(a), _j(b)),
        TV.where(torch.from_numpy(mask), _t(a), _t(b)))
    _eq(JV.Vec3(*(-x for x in _j(a))), -_t(a))
    # refract of unit vectors at ratios past and below total reflection
    ua = a / np.linalg.norm(a, axis=1, keepdims=True)
    ub = b / np.linalg.norm(b, axis=1, keepdims=True)
    ratio = np.where(mask, 1.0 / 1.5, 1.5).astype(np.float32)
    _eq(JV.refract(_j(ua), _j(ub), jnp.asarray(ratio)),
        TV.refract(_t(ua), _t(ub), torch.from_numpy(ratio)), ulp=2)


def test_grad_safe_sqrt_value_and_gradient():
    x = np.array([-1.0, 0.0, 1e-30, 0.25, 4.0], np.float32)
    tx = torch.tensor(x, requires_grad=True)
    y = TV.grad_safe_sqrt(tx)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(JV.grad_safe_sqrt(x)))
    (g,) = torch.autograd.grad(y.sum(), tx)
    jg = jax.grad(lambda v: JV.grad_safe_sqrt(v).sum())(jnp.asarray(x))
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    assert g[0] == 0 and g[1] == 0


def test_next_vec_and_seed_parity_match_the_reference():
    ids = np.arange(N, dtype=np.int64)
    js = JR.seed_parity(jnp.asarray(ids, jnp.uint32))
    ts = TR.seed_parity(torch.from_numpy(ids))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    mask = np.arange(N) % 3 != 0
    js2, jv = JR.next_vec(js, jnp.asarray(mask))
    ts2, tv = TR.next_vec(ts, torch.from_numpy(mask))
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))
    _eq(jv, tv)
    # pixel 0's stream is all zeros
    assert int(ts2[0]) == 0 and float(tv.x[0]) == 0.0
