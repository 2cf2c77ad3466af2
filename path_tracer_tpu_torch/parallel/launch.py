"""Start the ranks of a process group on this host.

`spawn(fn, world, args)` runs fn(*args) in `world` new processes (the
"spawn" start method), each a rank of one `torch.distributed` group that
it joins through `multihost.bring_up` from the standard environment
variables, on a free localhost port.  The tests, `dryrun.dryrun_multichip`
and chip_smoke.py start their ranks with it; on a cluster, `torchrun`
sets the same variables and `bring_up` joins its group.
"""
from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Callable, List, Sequence

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(device: str, world: int) -> str:
    """NCCL for ranks each on a card of its own; gloo on the CPU and for
    ranks that share a card, which NCCL refuses."""
    cuda = torch.device(device).type == "cuda"
    return ("nccl" if cuda and world <= torch.cuda.device_count()
            else "gloo")


def _rank_main(rank: int, world: int, port: int, device: str,
               fn: Callable, args: Sequence, out) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch.distributed as dist
    from .multihost import bring_up
    try:
        bring_up(None if device == "cuda" else device,
                 default_backend(device, world))
        out.put((rank, True, fn(*args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (),
          device: str = "cuda", timeout: float = 900.0) -> List:
    """fn(*args) on ranks 0..world-1 of a new process group, each rank in
    a process of its own on `device` ("cuda": cuda:{rank % device_count});
    returns their results in rank order.  fn must be importable by name
    and its result picklable (numpy, not tensors).  Raises with the
    rank's traceback if one fails, after stopping every rank.  The ranks
    join over `default_backend(device, world)`."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, port, device, fn, tuple(args), out))
        for r in range(world)]
    for p in procs:
        p.start()
    results, failed = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world and failed is None:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = out.get(timeout=min(max(left, 0.01), 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode]
                if left > 0 and not dead:
                    continue
                failed = (dead[0] if dead else -1,
                          "exited without a result" if dead
                          else f"no result within {timeout} s")
                break
            if ok:
                results[rank] = value
            else:
                failed = (rank, value)
    finally:
        for p in procs:
            p.join(timeout=30 if failed is None else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if failed is not None:
        raise RuntimeError(f"rank {failed[0]} of {world} failed: {failed[1]}")
    return [results[r] for r in range(world)]
