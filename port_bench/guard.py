"""The import guard: no process of the benchmark may hold JAX or the JAX
package.  Names are compared by their top-level part, whole, so
`path_tracer_tpu_torch` passes and `path_tracer_tpu` does not."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "path_tracer_tpu")


def loaded(modules=None) -> list:
    """The forbidden top-level names among `modules` (sys.modules)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))
