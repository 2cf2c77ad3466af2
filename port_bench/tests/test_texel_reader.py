"""The reader of `texel_stall_pct.fwd`: a share in [0, 100] of the
program's texel-service counters in a traced run of a textured cell, and
None where the program has no such counters or nothing was pending."""
from __future__ import annotations

import pytest

from port_bench import harness

SEED = 2 ** 31 + 977
NAME = "texel_stall_pct.fwd"


def _read(kind="frames"):
    return harness.reader(NAME).read(dict(kind=kind))


def test_traced_textured_cell_reads_a_share(tiny):
    path, root = tiny
    res, _ = harness.run_cell("tiny.frames", SEED, 0.0, True, "cpu",
                              bench_path=path, root=root)
    v = res["metrics"][NAME]["value"]
    assert 0.0 <= v <= 100.0


@pytest.mark.parametrize("pending,stalled,want", [
    (0, 0, None), (400, 0, 0.0), (400, 100, 25.0), (400, 400, 100.0)])
def test_share_of_the_counters(monkeypatch, pending, stalled, want):
    from path_tracer_tpu_torch.engine import wq
    monkeypatch.setattr(wq.wq_window_fb, "texel_pending", pending)
    monkeypatch.setattr(wq.wq_window_fb, "texel_stalled", stalled)
    assert _read() == want
    assert _read("train") is None


def test_a_program_without_the_counters_reads_none(monkeypatch):
    from path_tracer_tpu_torch.engine import wq
    monkeypatch.delattr(wq.wq_window_fb, "texel_pending")
    monkeypatch.delattr(wq.wq_window_fb, "texel_stalled")
    assert _read() is None
