"""The goldens under tests/golden/jax_ref/ against the JAX package they
stand for: each is recomputed through tools/make_jax_goldens.py's own
function and must equal its file, leaf for leaf.  The port's tests read
the goldens in place of compiling these references again on every run;
this check keeps them true to the frozen package.  It fails when jax or
jaxlib computes another value (a new version, or a host whose XLA
compiles otherwise), or when `INPUTS` changed and the golden was not
recorded again.  Those live checks take minutes and run in the `slow`
lane; in the default lane, `load` refuses a golden recorded by another
jax or jaxlib than the installed one, or for other inputs."""
import json

import numpy as np
import pytest

from tools import make_jax_goldens as golden


@pytest.mark.slow     # a golden's live check: one JAX reference, 36-127 s
@pytest.mark.parametrize("name", sorted(golden.RECIPES))
def test_golden_equals_the_jax_package(name):
    want = golden.load(name, golden.INPUTS[name])
    got = golden.compute(name)
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        np.testing.assert_array_equal(np.asarray(value), want[key],
                                      err_msg=f"{name}: {key}")


@pytest.mark.parametrize("stale", ["jax", "jaxlib", "inputs"])
def test_load_refuses_a_golden_recorded_otherwise(stale, tmp_path,
                                                  monkeypatch):
    """A golden recorded by another jax or jaxlib, or for other inputs,
    is refused with the command that records it again."""
    monkeypatch.setattr(golden, "GOLDEN_DIR", str(tmp_path))
    inputs = golden.INPUTS["torch_edge"]
    meta = dict(name="torch_edge", **golden.versions(), inputs=inputs)
    meta[stale] = "0.0.0" if stale != "inputs" else dict(inputs, grad=None)
    np.savez(golden.path("torch_edge"), __meta__=np.array(json.dumps(meta)),
             radius=np.float32(1.0))
    with pytest.raises(AssertionError,
                       match="python tools/make_jax_goldens.py torch_edge"):
        golden.load("torch_edge", inputs)
    meta[stale] = (golden.versions()[stale] if stale != "inputs"
                   else inputs)
    np.savez(golden.path("torch_edge"), __meta__=np.array(json.dumps(meta)),
             radius=np.float32(1.0))
    assert golden.load("torch_edge", inputs) == {"radius": 1.0}
