"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source `csrc/<name>.cu` has a plain C interface and compiles on its
own into `_build/lib<name>-<hash>.so` (the directory is git-ignored), keyed
by a hash of the source and the flags, so an edited kernel rebuilds.  The
build happens at first use; `build_all` starts one nvcc per source, all at
once, for callers that want every kernel up front.

Flags: Hopper only (`sm_90a`), `-fmad=false` so every float op rounds on
its own exactly as the plain PyTorch version does, and no fast math, so
divides and sqrt stay IEEE.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("wave_bounce", "spike_pmat")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}     # nvcc's output (ptxas registers/spills)


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    out = lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build_all(names: List[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one nvcc each,
    all started together.  Returns the seconds each took (0 if it was
    already built); raises on the first failure with nvcc's output."""
    t0 = time.perf_counter()
    jobs = [(n, *_start(n)) for n in names if not lib_path(n).exists()]
    took = {n: 0.0 for n in names}
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        os.replace(tmp, out)
        took[name] = time.perf_counter() - t0
    return took


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
