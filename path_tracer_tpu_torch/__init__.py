"""path_tracer_tpu_torch — the PyTorch + CUDA port of the JAX path tracer.

The JAX package beside this one is the reference; this package mirrors
its module names so each counterpart is easy to find, and imports neither
JAX nor anything of the reference.  Entry points take an explicit `device=`
and default to "cuda"; they run on the CPU only when the caller asks for
it (the tests do), and raise when CUDA is asked for but absent.

The forward work-queue render (`engine.wq.render_wq`; its one-bounce
driver with `window=1`) runs every bounce through one hand-written CUDA
kernel (`ops/csrc/wave_bounce.cu`), whose plain PyTorch version
(`ops.bounce_core`) is the executable spec.  The gradient entry point
`make_render_grad` (`diff.pallas_vjp`) takes, on the canonical (pixel,
sample) grid, the queued route (`diff.queued_vjp.render_grad_fb`), which
records with the same kernel and replays under autograd, or with
`queued=False` the pixel-pinned route; `render_grad_fn` differentiates any
(pixel, sample) list through the pinned route.
`parallel.mesh.make_train_step` is the one-device SGD step of inverse
rendering built on the queued route.  The nearest-sphere
spike (`ops.spike_pmat`) has its own kernel, `ops/csrc/spike_pmat.cu`.
The command line (`python -m path_tracer_tpu_torch render|info|bench`,
`cli.py`) renders the five presets through `render_wq`, with checkpoints
(`engine.checkpoint`) and a `torch.profiler` trace (`utils.profiling`).
Across devices (`parallel`), one `torch.distributed` rank a device:
`render_sharded` splits a frame's pixels and samples over a (tiles, spp)
mesh of ranks (`make_mesh`, `global_mesh`), `assemble_image` gathers it,
`make_train_step(mesh=...)` all-reduces the gradients, `bring_up` joins
the group `torchrun` describes, and `dryrun.dryrun_multichip` checks it
all on n ranks.  The oracle engines are torch ops on any device:
`engine.intersect`, `engine.scatter` and `engine.integrator` (`trace`,
`render_parity`, `render_perf`, `render_fused`, `render_wavefront`), the
yardstick `render_wq` is held against, and `diff.edge`'s silhouette
gradients.
"""

from .core.camera import Camera
from .core.vec import Vec3
from .scene.builder import SceneBuilder
from .diff.pallas_vjp import make_render_grad, render_grad_fn
from .diff.queued_vjp import render_grad_fb
from .engine.integrator import render_parity, render_perf, trace
from .parallel.mesh import make_mesh, make_train_step, render_sharded
from .parallel.multihost import assemble_image, bring_up, global_mesh

__all__ = ["Camera", "Vec3", "SceneBuilder", "render_parity",
           "render_perf", "trace", "make_render_grad", "render_grad_fn",
           "render_grad_fb", "make_train_step",
           "make_mesh", "render_sharded", "assemble_image", "bring_up",
           "global_mesh"]
__version__ = "0.2.0"
