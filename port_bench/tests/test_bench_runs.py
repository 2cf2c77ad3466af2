"""Each kind of traffic end to end at a tiny size on the CPU, with the
kernel's plain version, through a throwaway cell made of new files; the
result line's keys; `correct` false under each fault a cell can have;
the control's readings; and a run that finds no card exits without a
result."""
from __future__ import annotations

import json

import pytest
import torch

from port_bench import control, harness

SEED = 2 ** 31 + 977
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run(tiny, cell, trace=False, seconds=0.0, seed=SEED):
    path, root = tiny
    return harness.run_cell(f"tiny.{cell}", seed, seconds, trace, "cpu",
                            bench_path=path, root=root)


@pytest.mark.parametrize("cell", ["frames", "preview"])
def test_cell_runs_and_is_correct(tiny, cell):
    res, lines = run(tiny, cell, seconds=0.0)
    assert set(res) == KEYS and list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"setup_s", "fwd_mray_s", "frame_p95_ms"} <= set(res["metrics"])
    assert res["device"]["compiled"] is False
    assert lines[-len(res["checks"]):] == [
        f"check {k} {c['value']!r} limit {c['limit']!r}"
        for k, c in res["checks"].items()]
    json.dumps(res)


@pytest.mark.parametrize("cell", ["frames", "preview"])
def test_traced_run(tiny, cell):
    res, _ = run(tiny, cell, trace=True, seconds=0.0)
    assert set(res) == KEYS | {"breakdown"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0 and res["correct"]
    assert res["metrics"]["occupancy.fwd"]["value"] > 0


def _patch_render(monkeypatch, fault):
    from path_tracer_tpu_torch.engine import wq
    real, first = wq.render_wq, {}

    def render(scene, cam, w, h, spp, **kw):
        if fault == "half":
            img, segs, it, ls = real(scene, cam, w, h, max(spp // 2, 1),
                                     **kw)
            return img, segs * 2, it, ls
        out = real(scene, cam, w, h, spp, **kw)
        if fault == "unchanged":
            return first.setdefault("out", out)
        img = out[0].clone()
        img.view(-1, 3)[::7] *= 1.01
        return (img,) + tuple(out[1:])

    monkeypatch.setattr(wq, "render_wq", render)


@pytest.mark.parametrize("cell,fault", [
    ("frames", "unchanged"), ("frames", "half"), ("frames", "altered"),
    ("preview", "unchanged"), ("preview", "altered")])
def test_frame_faults(tiny, monkeypatch, cell, fault):
    """A 1-spp pass has no half of its samples to leave out."""
    _patch_render(monkeypatch, fault)
    res, _ = run(tiny, cell, seconds=0.0)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["frames", "preview"])
def test_control_fails(tiny, cell):
    """The reference in bfloat16, in the program's place, is not
    correct."""
    path, root = tiny
    r = control.readings(f"tiny.{cell}", SEED, 3, "cpu", bench_path=path,
                         root=root)
    lim = harness.limits(f"tiny.{cell}", root)
    for name, nums in r.items():
        assert any(not v <= lim[k] for k, v in nums.items()
                   if not k.startswith("_")), (name, nums)


def test_same_seed_same_answers(tiny):
    a, _ = run(tiny, "preview", seconds=0.0)
    b, _ = run(tiny, "preview", seconds=0.0)
    assert a["checks"] == b["checks"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "cornell_box.preview1", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
