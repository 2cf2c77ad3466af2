"""The import guard compares whole top-level names."""
from port_bench import guard


def test_guard_names():
    assert guard.loaded(["path_tracer_tpu.engine.wq", "numpy"]) == \
        ["path_tracer_tpu"]
    assert guard.loaded(["path_tracer_tpu_torch.engine.wq",
                         "path_tracer_tpu_torch"]) == []
    assert guard.loaded(["jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]
    assert guard.loaded(["jaxtyping", "flaxen"]) == []


def test_harness_loads_no_jax():
    """What a run imports, in a fresh process, holds no JAX."""
    import subprocess
    import sys
    from pathlib import Path
    code = ("from port_bench import harness, control, guard\n"
            "harness.kind('frames')\n"
            "import path_tracer_tpu_torch.engine.wq, "
            "path_tracer_tpu_torch.utils.image\n"
            "assert guard.loaded() == [], guard.loaded()\n")
    root = Path(__file__).resolve().parents[2]
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
