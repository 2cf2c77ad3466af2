"""The system under test's scene: a configuration's calls replayed through
the program's public `SceneBuilder`, and its camera made by the program's
`Camera.create`."""
from __future__ import annotations

import numpy as np


def _arg(cfg, a, refs):
    if isinstance(a, dict) and "ref" in a:
        return refs[a["kind"]](a["ref"])
    if isinstance(a, dict) and "image" in a:
        return cfg.image(a)
    if isinstance(a, list):
        return tuple(_arg(cfg, x, refs) for x in a)
    return a


def build(cfg, width: int, height: int, device):
    """(scene, camera) of configuration module `cfg` for a width x height
    frame, on `device`."""
    from path_tracer_tpu_torch import Camera, SceneBuilder
    from path_tracer_tpu_torch.scene.builder import MaterialRef, TextureRef
    sb = SceneBuilder()
    refs = {"mat": MaterialRef, "tex": TextureRef}
    for name, *args in cfg.CALLS:
        getattr(sb, name)(*[_arg(cfg, a, refs) for a in args])
    c = cfg.CONFIG["camera"]
    focus = c["focus"]
    if focus is None:
        d = (np.asarray(c["look_at"], np.float32)
             - np.asarray(c["look_from"], np.float32))
        focus = float(np.sqrt(np.sum(d * d)))
    cam = Camera.create(c["look_from"], c["look_at"], c["vup"], c["vfov"],
                        width / height, c["aperture"], focus, c["time0"],
                        c["time1"])
    return sb.build(device=device), cam
