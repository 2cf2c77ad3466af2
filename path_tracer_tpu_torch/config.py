"""Runtime render configuration.

The reference's configuration is compile-time (CMake options ->
preprocessor defines, build_parameters.hpp:3-19; samples and depth
hard-coded at main.cpp:186 / render.hpp:144); here the same knobs are a
runtime dataclass, as in the reference package's `config.py`.  `device`
stands where the reference package reads `JAX_PLATFORMS`: the port's entry
points take their device explicitly.
"""
from __future__ import annotations

import dataclasses

# The launch strategies, the reference's: the CLI's --renderer choices,
# RenderConfig.validate and the auto rule (cli.resolve_auto_renderer) all
# key off this.
RENDERERS = ("auto", "wq", "wavefront", "fused", "perf", "parity")
DEVICES = ("cuda", "cpu")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Every knob the reference exposes (and the ones it hard-codes).

    width/height — CMake OUTPUT_WIDTH/HEIGHT (CMakeLists.txt:44-54,
    default 800x480); spp — main.cpp:186 (100); max_depth —
    render.hpp:144 (50).
    """
    scene: str = "final_scene"
    width: int = 800
    height: int = 480
    spp: int = 100
    max_depth: int = 50
    # auto: the work queue on CUDA, the wavefront engine on the CPU
    renderer: str = "auto"
    seed: int = 0
    t_min: float = 1e-3
    # False replicates the reference's emission quirk (render.hpp:73):
    # scatter-miss returns emitted WITHOUT the path throughput factor.
    attenuate_emission: bool = False
    out: str = "out.png"
    ppm: bool = False                # also dump PPM (main.cpp:17-31)
    # wavefront tuning (the CLI's renderer="wavefront" takes these)
    tile_pix: int = 16384
    slots: int = 4
    # checkpointing: save partial accumulators every N spp; "" disables
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    profile_dir: str = ""            # torch.profiler trace output
    device: str = "cuda"

    def validate(self) -> "RenderConfig":
        from .scene.presets import PRESETS
        if self.scene not in PRESETS:
            raise ValueError(
                f"unknown scene {self.scene!r}; have {sorted(PRESETS)}")
        if self.renderer not in RENDERERS:
            raise ValueError(f"unknown renderer {self.renderer!r}; "
                             f"have {RENDERERS}")
        if self.device not in DEVICES:
            raise ValueError(f"unknown device {self.device!r}; "
                             f"have {DEVICES}")
        for f in ("width", "height", "spp", "max_depth"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive")
        return self

    @classmethod
    def for_preset(cls, name: str, **overrides) -> "RenderConfig":
        """Config pre-filled with a preset's staged benchmark geometry."""
        from .scene.presets import PRESETS
        if name not in PRESETS:
            raise ValueError(f"unknown scene {name!r}; have {sorted(PRESETS)}")
        p = PRESETS[name]
        base = dict(scene=name, width=p.width, height=p.height, spp=p.spp,
                    max_depth=p.max_depth)
        base.update(overrides)
        return cls(**base).validate()
