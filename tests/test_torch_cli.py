"""The port's command line as a whole against the reference, on the CPU.

One reference render: the reference package's `render_wq` of cornell_box
at 16x16, 4 spp, depth 6, with the tile rows and window of the port's CPU
defaults (`engine/wq.py`: 8 and 3), its kernel in interpret mode, read
from the golden tests/golden/jax_ref/torch_cli.npz, which
tools/make_jax_goldens.py records from the frozen package.  The
port renders the same preset through `cli.main(["render", ...,
"--device", "cpu", "--renderer", "wq"])` (on the CPU `auto` is the
wavefront engine, as in the reference), the plain PyTorch version of the
bounce kernel.  The
envelope is tests/test_torch_wq.py's: at most 3% of pixels beyond 5e-3
(knife-edge paths, docs/PERF_NOTES.md:67-75), traced segments within 0.2%
and the same number of bounce iterations.  `bench` renders its preset
at 16x16 here: the test checks the line it prints.
"""
import contextlib
import io
import json

import numpy as np
import pytest
from PIL import Image

from path_tracer_tpu_torch import cli
from path_tracer_tpu_torch.engine import wq as TWQ
from path_tracer_tpu_torch.utils import profiling
from path_tracer_tpu_torch.utils.image import dump_ppm, tonemap
from tools import make_jax_goldens as golden

W, H, SPP, DEPTH = 16, 16, 4, 6
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}   # the reference's


@pytest.fixture(scope="module")
def reference():
    g = golden.load("torch_cli", dict(
        scene="cornell_box", width=W, height=H, spp=SPP, max_depth=DEPTH,
        tile_rows=TWQ.CPU_TILE_ROWS, window=TWQ.CPU_WINDOW))
    return g["img"], float(g["segs"]), int(g["iters"])


@pytest.fixture(scope="module")
def cli_render(tmp_path_factory):
    """The CLI's render with its PNG, stdout and the float image it
    rendered (caught on its way from `render_wq`)."""
    mp = pytest.MonkeyPatch()
    seen = []

    def spy(*a, **k):
        out = TWQ.render_wq(*a, **k)
        seen.append(out)
        return out

    mp.setattr(cli, "render_wq", spy)
    timers = []

    class KeptTimer(profiling.PhaseTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    mp.setattr(cli.profiling, "PhaseTimer", KeptTimer)
    png = str(tmp_path_factory.mktemp("cli") / "cornell.png")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["render", "--scene", "cornell_box", "--width",
                           str(W), "--height", str(H), "--spp", str(SPP),
                           "--max-depth", str(DEPTH), "--device", "cpu",
                           "--renderer", "wq", "-o", png, "--metrics",
                           "--ppm"])
    finally:
        mp.undo()
    assert len(seen) == 1
    img, segs, iters, _ = seen[0]
    return dict(rc=rc, png=png, out=buf.getvalue(), img=img.numpy(),
                segs=segs, iters=iters, timer=timers[0])


def test_cli_render_exits_zero_and_writes_the_tonemapped_png(cli_render):
    assert cli_render["rc"] == 0
    back = np.asarray(Image.open(cli_render["png"]))
    assert back.shape == (H, W, 3)
    np.testing.assert_array_equal(back, tonemap(cli_render["img"]))


def test_cli_render_inside_the_reference_envelope(cli_render, reference):
    rimg, rsegs, riters = reference
    img = cli_render["img"]
    assert img.shape == rimg.shape and np.isfinite(img).all()
    d = np.abs(img - rimg).max(axis=-1)
    assert float((d > 5e-3).mean()) <= 0.03, float(d.max())
    assert abs(cli_render["segs"] - rsegs) <= 0.002 * rsegs, (
        cli_render["segs"], rsegs)
    assert cli_render["iters"] == riters


def test_cli_render_metrics_and_ppm(cli_render):
    *ppm, metrics = cli_render["out"].rstrip("\n").split("\n")
    m = json.loads(metrics)
    assert m["mray_per_s"] > 0
    assert m["avg_path_len"] == round(cli_render["segs"] / (W * H * SPP), 3)
    # the reference's phases, and its rate over their sum (write included)
    assert set(m["phases_s"]) == {"compile+render", "write"}
    phases = cli_render["timer"].phases
    assert m["mray_per_s"] == round(
        cli_render["segs"] / sum(phases.values()) / 1e6, 3)
    assert "\n".join(ppm) + "\n" == dump_ppm(cli_render["img"])


def test_cli_bench_prints_one_json_line(capsys, monkeypatch):
    monkeypatch.setitem(cli.PRESETS, "three_spheres", cli.PRESETS[
        "three_spheres"]._replace(width=W, height=H))
    assert cli.main(["bench", "--scene", "three_spheres", "--spp", "1",
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert BENCH_KEYS <= set(out)
    assert out["metric"] == "forward Mray/s (three_spheres)"
    assert out["unit"] == "Mray/s" and out["value"] > 0
    assert out["backend"] == "cpu"
