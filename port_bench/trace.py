"""The traced window: `torch.profiler`'s device and host events, reduced in
memory (no Chrome trace is written).

`Profile` starts the Kineto profiler through PyTorch's low-level calls,
which hand the events back without building one Python object per event,
and marks the traced window with a user annotation.  `summarize` reduces
the events to what the per-layer readers need: the window's length, the
union of device activity inside it, device time by name, and the
breakdown the result line carries.
"""
from __future__ import annotations

import numpy as np
import torch

WINDOW_MARK = "port_bench.window"


class Profile:
    """Profiles the host and, on CUDA, the device, until `stop`."""

    def __init__(self, cuda: bool):
        from torch.autograd import ProfilerActivity
        self.acts = {ProfilerActivity.CPU}
        if cuda:
            self.acts.add(ProfilerActivity.CUDA)
        self.result = None
        self.mark = None

    def start(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import (ProfilerConfig, ProfilerState,
                                    _enable_profiler, _prepare_profiler)
        cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                             False, _ExperimentalConfig())
        _prepare_profiler(cfg, self.acts)
        _enable_profiler(cfg, self.acts)
        self.mark = torch.profiler.record_function(WINDOW_MARK)
        self.mark.__enter__()

    def stop(self) -> None:
        from torch.autograd import _disable_profiler
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.result = _disable_profiler()


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of [starts, ends) as two arrays."""
    if starts.size == 0:
        return starts, ends
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    run = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.maximum.reduceat(e, idx)


def summarize(prof: Profile, top: int = 10) -> dict:
    """The traced window's numbers (seconds unless named otherwise)."""
    ev = prof.result.events()
    n = len(ev)
    names = [e.name() for e in ev]
    dev = np.fromiter((e.device_type() != torch.autograd.DeviceType.CPU
                       for e in ev), bool, n)
    st = np.fromiter((e.start_ns() for e in ev), np.int64, n)
    du = np.fromiter((e.duration_ns() for e in ev), np.int64, n)
    th = np.fromiter((e.start_thread_id() for e in ev), np.int64, n)
    marks = [i for i, nm in enumerate(names) if nm == WINDOW_MARK and
             not dev[i]]
    if not marks:
        raise RuntimeError("the traced window's mark is missing")
    w0, w1 = int(st[marks[0]]), int(st[marks[0]] + du[marks[0]])
    en = st + du

    # device: union of activity clipped to the window, time by name
    d = np.flatnonzero(dev & (en > w0) & (st < w1))
    d = d[[names[i] != WINDOW_MARK for i in d.tolist()]]
    ds, de = np.clip(st[d], w0, w1), np.clip(en[d], w0, w1)
    us, ue = _union(ds, de)
    busy = int((ue - us).sum())
    by_name: dict = {}
    for i, t in zip(d.tolist(), (de - ds).tolist()):
        by_name[names[i]] = by_name.get(names[i], 0) + t

    # host: ATen ops not nested in another ATen op of their thread (an
    # op's own sub-ops, and autograd's and the runtime's events, are not
    # counted)
    h = np.flatnonzero(~dev & (st >= w0) & (en <= w1))
    h = h[[names[i].startswith("aten::") for i in h.tolist()]]
    top_ops = []
    for t_id in np.unique(th[h]):
        hi = h[th[h] == t_id]
        hi = hi[np.lexsort((-du[hi], st[hi]))]
        run = np.maximum.accumulate(en[hi])
        outer = np.ones(hi.size, bool)
        outer[1:] = st[hi][1:] >= run[:-1]
        top_ops.append(hi[outer])
    top_ops = np.concatenate(top_ops) if top_ops else np.zeros(0, np.int64)

    # idle gaps on the device, named by the host op running at their middle
    gs = np.concatenate([[w0], ue])
    ge = np.concatenate([us, [w1]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    gaps: dict = {}
    if top_ops.size and gs.size:
        o = top_ops[np.argsort(st[top_ops], kind="stable")]
        mid = (gs + ge) // 2
        k = np.searchsorted(st[o], mid, side="right") - 1
        for g, kk, m in zip((ge - gs).tolist(), k.tolist(), mid.tolist()):
            nm = names[o[kk]] if kk >= 0 and en[o[kk]] >= m else "(between host ops)"
            gaps[nm] = gaps.get(nm, 0) + g
    ns = 1e-9
    best = lambda dd: [[k, v * ns] for k, v in
                       sorted(dd.items(), key=lambda kv: -kv[1])[:top]]
    return dict(window_s=(w1 - w0) * ns, busy_s=busy * ns,
                device_s={k: v * ns for k, v in by_name.items()},
                device_ops=best(by_name),
                idle_gaps=best(gaps))
