"""The port's nearest-sphere spike (kernel K2) against the reference's
Pallas kernel `tools/spike_pmat.py:kernel`, run in interpret mode on the
CPU, at 8 x 128 rays and P = 512 spheres from a numpy seed.

Tolerances, and why:
* meta (the winner's attribute, or 0 on a miss) and the miss pattern of
  t are equal on every ray: the winner is a discrete choice;
* t, the winning key in t*|d|^2 space, is within 5e-5 relative
  (magnitudes floored at 1) on every ray, and bit-equal or within 4 ulp
  on >= 60% (measured 65%).  Not every ray is within a few ulp, because
  XLA's CPU compiler contracts a*b+c into one fused multiply-add inside
  the interpret-mode kernel, while the port (and its CUDA kernel, built
  with -fmad=false) rounds every op; -b - sqrt(disc) then cancels and
  amplifies that one rounding, up to ~400 ulp of a small key (measured).
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from path_tracer_tpu_torch.ops import spike_pmat as TS

ROWS = 8


def _reference_module():
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "spike_pmat.py")
    spec = importlib.util.spec_from_file_location("_ref_spike_pmat", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def case():
    ref = _reference_module()
    assert ref.P == TS.P and ref.A == TS.A
    tab, attrs, *planes = TS.make_inputs(ROWS, seed=0, device="cpu")
    vspec = pl.BlockSpec((ROWS, 128), lambda i: (i, 0),
                         memory_space=pltpu.VMEM)
    full = pl.BlockSpec(memory_space=pltpu.VMEM)
    f = pl.pallas_call(
        functools.partial(ref.kernel, rows=ROWS), grid=(1,),
        in_specs=[full, full] + [vspec] * 7, out_specs=[vspec] * 2,
        out_shape=[jax.ShapeDtypeStruct((ROWS, 128), jnp.float32)] * 2,
        interpret=True)
    jt, jm = f(*[jnp.asarray(x.numpy()) for x in (tab, attrs, *planes)])
    before = TS.spike_pmat.launches
    tt, tm = TS.spike_pmat(tab, attrs, *planes)
    return dict(jt=np.asarray(jt), jm=np.asarray(jm), tt=tt.numpy(),
                tm=tm.numpy(), launched=TS.spike_pmat.launches - before)


def test_meta_equal(case):
    np.testing.assert_array_equal(case["tm"], case["jm"])
    hit = np.isfinite(case["jt"])
    assert 0.2 < hit.mean() < 0.9                # hits and misses both
    assert (case["jm"][~hit] == 0).all()


def test_t_within_stated_tolerance(case):
    jt, tt = case["jt"], case["tt"]
    np.testing.assert_array_equal(np.isinf(jt), np.isinf(tt))
    fin = np.isfinite(jt)
    x, y = jt[fin].astype(np.float64), tt[fin].astype(np.float64)
    rel = np.abs(x - y) / np.maximum(np.abs(x), 1.0)
    assert rel.max() <= 5e-5, rel.max()
    ulp = np.abs(jt[fin].view(np.int32).astype(np.int64)
                 - tt[fin].view(np.int32).astype(np.int64))
    assert (ulp <= 4).mean() >= 0.6, (ulp <= 4).mean()


def test_cpu_tensors_take_the_plain_version(case):
    assert case["launched"] == 0


def test_ties_take_the_lowest_index():
    """Sphere p repeats sphere p % 4: of equal keys the lowest index wins,
    as the reference's min over `where(key == m, iota, P)`."""
    tab, attrs, *planes = TS.make_inputs(ROWS, seed=3, device="cpu")
    tab = tab[:4].repeat(TS.P // 4, 1)
    attrs[TS.META_ROW] = torch.arange(TS.P, dtype=torch.float32)
    t, meta = TS.spike_pmat_plain(tab, attrs, *planes)
    hit = torch.isfinite(t)
    assert hit.sum() > 10 and (meta[hit] < 4).all()


def test_run_on_cpu_and_bound():
    out = TS.run(TS.TILE_ROWS, trials=1, device="cpu")
    assert out["rows"] == TS.TILE_ROWS and out["ms"] > 0
    rays = TS.TILE_ROWS * 128
    w = TS.work(*TS.make_inputs(TS.TILE_ROWS, device="cpu"))
    b = TS.bound_ms(w, 67e12, 3.35e12)
    assert b["bound_by"] == "operations"
    assert b["bytes"] == 4 * (rays * 9 + 512 * 9 + 14 * 512)
    # the prefix on every pair, the roots only where disc > 0 (1-2% of the
    # spike's pairs), the keep only where that gives a key
    assert w["pairs"] == rays * 512
    assert 0.01 < w["disc_pos"] / w["pairs"] < 0.02
    assert 0 < w["keyed"] < w["disc_pos"]
    assert w["warps"] == rays // 32 * 512
    assert w["disc_pos"] / 32 < w["warps_pos"] < w["disc_pos"]
    assert w["ops"] == (w["pairs"] * 26 + w["disc_pos"] * 8 + w["keyed"]
                        + rays * 7)
    assert w["ops_all"] == rays * (512 * 38 + 7) > w["ops"]
    with pytest.raises(ValueError, match="multiple"):
        TS.run(10, device="cpu")
