"""Tracing and metrics: per-phase wall timers, Mray/s counters and an
optional `torch.profiler` trace.

Mirrors the reference package's `utils/profiling.py`.  A phase is wall
time: the caller ends it on a host copy of its result (the CLI's render
phase ends with the image on the host), so the device's work is in it;
`trace` writes a Chrome trace that `chrome://tracing` or Perfetto opens.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

log = logging.getLogger("path_tracer_tpu_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)

TRACE_FILE = "trace.json"   # the Chrome trace `trace` writes in its directory


@dataclass
class PhaseTimer:
    """Accumulates wall time and ray counts per phase."""
    phases: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    rays: float = 0.0        # traced path segments
    samples: float = 0.0     # camera rays

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def add_rays(self, segments: float, samples: float) -> None:
        self.rays += float(segments)
        self.samples += float(samples)

    def summary(self) -> dict:
        render_s = self.phases.get("render", sum(self.phases.values()))
        out = {
            "phases_s": {k: round(v, 4) for k, v in self.phases.items()},
            "calls": dict(self.counts),
        }
        if self.rays and render_s:
            out["mray_per_s"] = round(self.rays / render_s / 1e6, 3)
            out["camera_mray_per_s"] = round(
                self.samples / render_s / 1e6, 3)
            out["avg_path_len"] = round(self.rays / max(self.samples, 1), 3)
        return out


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """`torch.profiler` trace of a block, written as a Chrome trace to
    `<profile_dir>/trace.json`: host ops always, and the CUDA kernels when
    a CUDA device is present.  Yields the profiler (None, and a no-op, if
    the directory is empty)."""
    if not profile_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(profile_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def device_memory_stats() -> List[dict]:
    """Per-device memory stats of PyTorch's CUDA allocator ([] without
    CUDA)."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return out
