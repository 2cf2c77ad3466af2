"""Runs one cell of `BENCHMARK.json` once and returns its result line.

Everything that belongs to one configuration, traffic mix, kind of work
or metric is a file found by its name:

- `configs/<config>.py`: the scene as data (`CALLS`, `CONFIG`, `image`);
- `traffic/<traffic>.json`: the mix's parameters, `kind` among them;
- `kinds/<kind>.py`: `setup`, `unit`, `release`, `check`, `control`;
- `metrics/<metric>.py`: `read(run)`, a number or None;
- `limits/<cell>.json`: the limit of each number that decides `correct`.

A run: set-up (the kind's, warm-up included), then units back to back
until `seconds` have passed (none starts later; the window closes at the
end of the last), then the peak memory is read, the program's state
freed and the plain reference judges what the window produced.  With
`trace`, the profiler records the window's first `trace_units` units and
the per-layer readers take their numbers from that.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import guard
from .reference import scene as ref_scene
from .trace import Profile, summarize

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "port_bench._" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def cell(b: dict, name: str) -> dict:
    for w in b["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in the benchmark")


def config(b: dict, name: str, base: Path = ROOT.parent):
    """The configuration module; `file` is relative to `base`, the
    directory that holds BENCHMARK.json."""
    for c in b["configs"]:
        if c["name"] == name:
            return load_module(Path(base) / c["file"])
    raise KeyError(f"no config {name!r} in the benchmark")


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "traffic" / f"{name}.json").read_text())


def kind(name: str, root: Path = ROOT):
    return load_module(Path(root) / "kinds" / f"{name}.py")


def reader(name: str, root: Path = ROOT):
    return load_module(Path(root) / "metrics" / f"{name}.py")


def limits(name: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "limits" / f"{name}.json").read_text())


def metrics_of(b: dict, cell_name: str, section: str) -> list:
    """The metrics of `section` this cell reports."""
    return [m for m in b[section]
            if "workloads" not in m or cell_name in m["workloads"]]


def context(b: dict, name: str, seed: int, device, overrides=None,
            root: Path = ROOT, base: Path = ROOT.parent):
    w = cell(b, name)
    cfg = config(b, w["config"], base)
    tr = traffic(w["traffic"], root)
    tr.update(overrides or {})
    return SimpleNamespace(cell=name, cfg=cfg, traffic=tr, seed=int(seed),
                           device=torch.device(device), tracing=False,
                           kind=kind(tr["kind"], root), chips=w["chips"],
                           root=Path(root))


def process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        hz = os.sysconf("SC_CLK_TCK")
        return time.time() - uptime + start_ticks / hz
    except (OSError, ValueError, IndexError):
        return time.time()


def _device(ctx) -> dict:
    """The result's `device`; `compiled` is true where this process ran
    nvcc (a checkout's first run), whose set-up holds K1's build."""
    from path_tracer_tpu_torch.ops import build
    if ctx.device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                    count=ctx.chips,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated()),
                    compiled=bool(build.build_log))
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0,
                compiled=False)


class GcPauses:
    """Python's garbage collections while it is open: how many of each
    generation, and the seconds they held the interpreter."""

    def __init__(self):
        self.n, self.s, self.t = [0, 0, 0], [0.0, 0.0, 0.0], None
        self.cb = self._cb
        gc.callbacks.append(self.cb)

    def _cb(self, phase, info):
        if phase == "start":
            self.t = time.perf_counter()
        elif self.t is not None:
            g = info["generation"]
            self.n[g] += 1
            self.s[g] += time.perf_counter() - self.t

    def close(self):
        if self.cb in gc.callbacks:
            gc.callbacks.remove(self.cb)

    def summary(self) -> dict:
        return dict(count=self.n, seconds=[round(x, 4) for x in self.s])


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             overrides=None, bench_path: Path = BENCHMARK, root: Path = ROOT,
             t_start=None):
    """One run of cell `name`; returns (result dict, check lines).
    `root` holds the configs, traffic, kinds, metrics and limits."""
    t_start = process_start() if t_start is None else t_start
    t_harness = time.time()
    b = bench(bench_path)
    ctx = context(b, name, seed, device, overrides, root,
                  Path(bench_path).parent)
    ctx.tracing = bool(trace)
    K = ctx.kind
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = K.setup(ctx)
    if cuda:
        torch.cuda.synchronize()

    from path_tracer_tpu_torch.ops import wave_bounce as WB
    n_trace = ctx.traffic.get("trace_units", 1)
    prof, lanes, records, traced = None, [], [], None

    def end_trace():
        prof.stop()
        WB.wave_bounce.events = None
        return dict(units=list(records),
                    launches=WB.wave_bounce.launches - launches0,
                    lanes=sum(n for n, _, _ in lanes))

    gc_pause = GcPauses()
    t0 = time.time()
    setup_s = t0 - t_start
    setup_parts = dict(start_to_harness=round(t_harness - t_start, 3),
                       kind_setup=round(t0 - t_harness, 3))
    w0 = time.perf_counter()
    launches0 = WB.wave_bounce.launches
    if trace:
        prof = Profile(cuda)
        WB.wave_bounce.events = lanes
        prof.start()
    while not records or time.perf_counter() - w0 < seconds:
        records.append(K.unit(state, len(records)))
        if trace and traced is None and len(records) == n_trace:
            traced = end_trace()
    window_s = time.perf_counter() - w0
    gc_pause.close()
    if trace and traced is None:       # fewer units than trace_units
        traced = end_trace()
    dev = _device(ctx)
    if traced is not None:
        traced.update(summarize(prof))
        prof = lanes = None
    K.release(state)
    if cuda:
        torch.cuda.empty_cache()

    run = dict(kind=ctx.traffic["kind"], traffic=ctx.traffic,
               config=ctx.cfg.CONFIG, setup_s=setup_s, window_s=window_s,
               units=records, traced=traced,
               rows=ref_scene.fold_rows(ctx.cfg))
    section = "per_layer" if trace else "end_to_end"
    out = {}
    for m in metrics_of(b, name, section):
        v = reader(m["name"], root).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}

    t_check = time.perf_counter()
    numbers = K.check(state, records)
    info = {k[1:]: numbers.pop(k) for k in list(numbers) if k[0] == "_"}
    per_unit = info.pop("per_unit", None)
    lim = limits(name, root)
    checks = {k: {"value": v, "limit": lim[k]} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    if per_unit is not None and "img_gap" in lim:
        failed = sum(1 for g in per_unit if not g <= lim["img_gap"])
    else:
        failed = 0 if correct else len(records)
    if trace:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
    result = dict(correct=correct, attempted=len(records), failed=failed,
                  metrics=out, device=dev)
    if trace:
        result["breakdown"] = dict(device_ops=traced["device_ops"],
                                   idle_gaps=traced["idle_gaps"])
    result["checks"] = checks
    lines = [f"port_bench: setup_s {setup_s:.3f} window_s {window_s:.3f} "
             f"units {len(records)} check_s "
             f"{time.perf_counter() - t_check:.3f}"]
    info["setup_parts"] = setup_parts
    info["unit_s"] = [round(r["t"], 4) for r in records]
    info["gc_in_window"] = gc_pause.summary()
    lines += [f"port_bench: {k} {json.dumps(v)}" for k, v in info.items()]
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    t_start = process_start()
    w = cell(bench(), a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"port_bench: {a.workload} needs {w['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, lines = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                             "cuda", t_start=t_start)
    bad = guard.loaded()
    if bad:
        print(f"port_bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
