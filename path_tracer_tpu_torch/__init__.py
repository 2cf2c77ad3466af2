"""path_tracer_tpu_torch — the PyTorch + CUDA port of the JAX path tracer.

The JAX package beside this one is the reference; this package mirrors
its module names so each counterpart is easy to find, and imports neither
JAX nor anything of the reference.  Entry points take an explicit `device=`
and default to "cuda"; they run on the CPU only when the caller asks for
it (the tests do), and raise when CUDA is asked for but absent.

The forward work-queue render (`engine.wq.render_wq`) runs every bounce
through one hand-written CUDA kernel (`ops/csrc/wave_bounce.cu`), whose
plain PyTorch version (`ops.bounce_core`) is the executable spec.  The
gradient route (`diff.queued_vjp.render_grad_fb`) records with the same
kernel and replays under autograd; `parallel.mesh.make_train_step` is the
one-device SGD step of inverse rendering built on it.  The nearest-sphere
spike (`ops.spike_pmat`) has its own kernel, `ops/csrc/spike_pmat.cu`.
The command line (`python -m path_tracer_tpu_torch render|info|bench`,
`cli.py`) renders the five presets through `render_wq`, with checkpoints
(`engine.checkpoint`) and a `torch.profiler` trace (`utils.profiling`).
"""

from .core.camera import Camera
from .core.vec import Vec3
from .scene.builder import SceneBuilder
from .diff.queued_vjp import render_grad_fb
from .parallel.mesh import make_train_step

__all__ = ["Camera", "Vec3", "SceneBuilder", "render_grad_fb",
           "make_train_step"]
__version__ = "0.2.0"
