"""Joining a process group, and the one cross-rank gather of a frame.

Mirrors the reference package's `parallel/multihost.py`.  There the JAX
runtime spans hosts; here each device is one process of a
`torch.distributed` group, which `torchrun` (or `parallel.launch.spawn`)
describes in the standard environment variables.  The spp axis of the
mesh is laid out over neighbouring ranks (spp is the faster axis), so its
reduction stays among one host's devices when n_spp divides the devices a
host has; the tiles axis needs no communication until `assemble_image`.

A single process needs none of it: `bring_up()` is then a no-op and
`global_mesh()` is the 1x1 mesh.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.profiling import log
from .mesh import Mesh, make_mesh, rank_device


def bring_up(device: Union[None, str, torch.device] = None,
             backend: Optional[str] = None) -> None:
    """Join the process group that RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT describe (what `torchrun` sets):
    NCCL when this rank's device (`mesh.rank_device`) is CUDA, gloo on
    the CPU, unless `backend` says otherwise.  A no-op for one process
    (WORLD_SIZE unset or 1) and when a group exists already."""
    if dist.is_initialized():
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return
    dev = rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]))
    log.info("distributed: rank %d/%d on %s over %s", dist.get_rank(), world,
             dev, backend)


def global_mesh(n_spp: int = 1,
                device: Union[None, str, torch.device] = None) -> Mesh:
    """The (tiles, spp) mesh over every rank of the process group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % n_spp:
        raise ValueError(f"{world} ranks do not split into spp={n_spp}")
    return make_mesh(world // n_spp, n_spp, device=device)


def assemble_image(local: torch.Tensor, mesh: Mesh, width: int,
                   height: int) -> np.ndarray:
    """The (H, W, 3) frame on every rank, from each rank's tile of
    `render_sharded`: the tiles all-gathered over the tiles axis, trimmed
    to the frame's pixels."""
    group = mesh.tiles_group
    if group is None:
        full = local
    else:
        # gloo gathers host tensors only, and the frame goes to the host
        # anyway: its tiles travel through host memory; NCCL gathers on the
        # device
        src = local.cpu() if dist.get_backend(group) == "gloo" else local
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.n_tiles)]
        mesh.collective(lambda: dist.all_gather(parts, src, group=group),
                        local)
        full = torch.cat(parts)
    return full[:width * height].reshape(height, width, 3).cpu().numpy()
