"""The port's app layer on the CPU: config, the CLI's parser and `info`,
profiling and the finite-image check (mirrors tests/test_app.py with the
renderers the port has)."""
import json
import os

import numpy as np
import pytest
import torch

from path_tracer_tpu.scene.presets import PRESETS as JPRESETS
from path_tracer_tpu_torch import cli
from path_tracer_tpu_torch.config import RENDERERS, RenderConfig
from path_tracer_tpu_torch.utils import profiling
from path_tracer_tpu_torch.utils.debug import assert_image_finite
from path_tracer_tpu_torch.utils.profiling import PhaseTimer


def test_config_presets_and_validation():
    cfg = RenderConfig.for_preset("three_spheres")
    assert (cfg.width, cfg.height, cfg.spp, cfg.max_depth) == (200, 100,
                                                               10, 8)
    assert cfg.device == "cuda"
    cfg2 = RenderConfig.for_preset("cornell_box", spp=7, renderer="wq",
                                   device="cpu")
    assert cfg2.spp == 7 and cfg2.renderer == "wq" and cfg2.device == "cpu"
    for bad in (dict(scene="nope"), dict(renderer="nope"),
                dict(renderer="cuda"), dict(spp=0), dict(width=-1),
                dict(device="tpu")):
        with pytest.raises(ValueError):
            RenderConfig(**bad).validate()
    with pytest.raises(ValueError):
        RenderConfig.for_preset("nope")


def _render_choices(parser, flag):
    render_sub = parser._subparsers._group_actions[0].choices["render"]
    for action in render_sub._actions:
        if flag in getattr(action, "option_strings", ()):
            return list(action.choices)
    raise AssertionError(f"render has no {flag}")


def test_every_cli_renderer_choice_validates():
    choices = _render_choices(cli._build_parser(), "--renderer")
    assert choices == list(RENDERERS) == ["auto", "wq", "wavefront",
                                          "fused", "perf", "parity"]
    for ch in choices:
        RenderConfig(renderer=ch).validate()        # must not raise
    assert _render_choices(cli._build_parser(), "--device") == ["cuda", "cpu"]


def test_cli_info_matches_the_reference_presets(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["backend"] == "cpu" and info["devices"] == ["cpu"]
    assert info["native_runtime"] is False
    assert info["presets"] == {
        name: {"width": p.width, "height": p.height, "spp": p.spp,
               "depth": p.max_depth} for name, p in JPRESETS.items()}


@pytest.mark.parametrize("argv", [
    ["render", "--scene", "three_spheres", "--spp", "1"],
    ["bench", "--scene", "three_spheres", "--spp", "1"],
    ["render", "--scene", "three_spheres", "--spp", "1", "--checkpoint-dir",
     "unused"],
])
def test_default_device_raises_without_cuda(argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv + ["-o", "x.png"] if argv[0] == "render" else argv)
    assert os.listdir(tmp_path) == []


def test_phase_timer_metrics():
    t = PhaseTimer()
    with t.phase("render"):
        pass
    with t.phase("write"):
        pass
    t.add_rays(segments=2e6, samples=1e6)
    s = t.summary()
    assert set(s) == {"phases_s", "calls", "mray_per_s", "camera_mray_per_s",
                      "avg_path_len"}
    assert s["avg_path_len"] == 2.0 and s["calls"] == {"render": 1,
                                                       "write": 1}
    assert PhaseTimer().summary() == {"phases_s": {}, "calls": {}}


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    d = str(tmp_path / "prof")
    with profiling.trace(d) as prof:
        torch.ones(64).add_(1).sum()
    assert prof is not None
    with open(os.path.join(d, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::add_" for e in events)
    with profiling.trace("") as none:
        assert none is None


def test_device_memory_stats_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == []


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_assert_image_finite(bad, as_tensor):
    img = np.zeros((4, 5, 3), np.float32)
    assert_image_finite(torch.from_numpy(img) if as_tensor else img)
    img[2, 3, 1] = bad
    with pytest.raises(FloatingPointError,
                       match=r"1 non-finite components.*\[\[2, 3\]\]"):
        assert_image_finite(torch.from_numpy(img) if as_tensor else img,
                            "frame")
