"""path_tracer_tpu_torch — the PyTorch + CUDA port of path_tracer_tpu.

The JAX package `path_tracer_tpu` is the reference; this package mirrors its
module names so each counterpart is easy to find, and imports neither JAX
nor anything of the reference.  Entry points take an explicit `device=`
and default to "cuda"; they run on the CPU only when the caller asks for
it (the tests do), and raise when CUDA is asked for but absent.

The forward work-queue render (`engine.wq.render_wq`) runs every bounce
through one hand-written CUDA kernel (`ops/csrc/wave_bounce.cu`), whose
plain PyTorch version (`ops.bounce_core`) is the executable spec.
"""

__version__ = "0.1.0"
