"""BENCHMARK.json against the contract's shape, and every name in it
against the files the harness finds it by."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from port_bench import harness

B = harness.bench()
ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = lambda s: isinstance(s, str) and 1 <= len(s) <= 200 and \
    "\n" not in s and "\t" not in s
METRICS = B["end_to_end"] + B["per_layer"]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(B)) <= 64 * 1024
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)


def test_paths_and_command():
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(B["command"]) <= 32 and all(LINE(w) for w in
                                                 B["command"])


def test_check_fits_its_time():
    n = 24       # the most cells later PRs may bring
    total = (2 + 14 * n) * (B["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", B["configs"] + B["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    for k in ("why", "layer", "source"):
        if k in entry:
            assert LINE(entry[k])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_fields(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if m in B["end_to_end"]:
        allowed |= {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert m["moves"] in [e["name"] for e in B["end_to_end"]]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert set(m) <= allowed
    cells = [w["name"] for w in B["workloads"]]
    assert all(c in cells for c in m.get("workloads", cells))
    assert (ROOT / "metrics" / f"{m['name']}.py").is_file()


def test_unique_names():
    for group in (B["configs"], B["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith(B["paths"][0] + "/")
    cfg = harness.config(B, c["name"])
    assert set(c["reduced"]) == set(cfg.CONFIG["reduced"])
    assert all(NAME.match(k) for k in c["reduced"])
    assert c["source"].split()[0] in cfg.SOURCE


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    """Every cell's configuration, traffic, kind and limits are files
    found by name, and it reports setup_s, another end-to-end metric and a
    per-layer one."""
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1
    cfg = harness.config(B, w["config"])
    tr = harness.traffic(w["traffic"])
    assert (ROOT / "kinds" / f"{tr['kind']}.py").is_file()
    assert harness.limits(w["name"])
    e2e = [m["name"] for m in harness.metrics_of(B, w["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(B, w["name"], "per_layer")
    for m in e2e:
        assert callable(harness.reader(m).read)


def test_every_config_used():
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
