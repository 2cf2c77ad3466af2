"""The port's `next_week_final` preset, the final scene of "Ray Tracing:
The Next Week", which the JAX package has no preset for.

On the CPU, beside the JAX package: the preset's calls made on the JAX
package's `SceneBuilder` give the port's arrays and pack to the port's
kernel tables bit for bit (1,008 sphere rows, one moving; 2,408 rect
rows; the triangle table's 8 rows of padding; 2 media); `info` lists
the preset, and `render --scene next_week_final --renderer wq` writes
its image through the work queue and reports its segments.
"""
import json

import numpy as np
import pytest
from PIL import Image

from path_tracer_tpu.ops.pallas import wave_bounce as JWB
from path_tracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from path_tracer_tpu_torch import cli
from path_tracer_tpu_torch.ops import wave_bounce as TWB
from path_tracer_tpu_torch.scene import presets as TP

from test_torch_scene import _assert_tree_equal

FIELDS = ("sph", "sph_segs", "rect", "rect_segs", "tri", "tri_segs", "med",
          "spec")


@pytest.fixture(scope="module")
def scenes():
    jsb, _ = TP.next_week_final_builder(JSceneBuilder())
    ts, _ = TP.NEXT_WEEK_FINAL.build(device="cpu")
    return jsb.build(), ts


def test_jax_builder_gives_the_ports_arrays(scenes):
    js, ts = scenes
    _assert_tree_equal(js, ts)


def test_jax_builder_packs_the_ports_tables(scenes):
    js, ts = scenes
    jt, tt = JWB.pack_scene(js), TWB.pack_scene(ts)
    for field in FIELDS:
        _assert_tree_equal(getattr(jt, field), getattr(tt, field), field)
    assert tt.sph.shape[1] == 1008 and tt.rect.shape[1] == 2408
    assert tt.tri.shape[1] == 8 and tt.med.shape[1] == 2
    moving = sum(e - s for s, e in tt.sph_segs.tolist())
    assert moving == 1
    assert TWB.k1_variant(2, tt.fold.shape[0] * 16) == "templated"


def test_info_lists_the_preset(capsys):
    assert cli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["presets"]["next_week_final"] == {
        "width": 800, "height": 800, "spp": 10000, "depth": 40}


def test_cli_renders_it_through_the_work_queue(tmp_path, capsys):
    png = tmp_path / "next_week_final.png"
    assert cli.main(["render", "--scene", "next_week_final", "--width",
                     "16", "--height", "16", "--spp", "1", "--max-depth",
                     "6", "--device", "cpu", "--renderer", "wq", "-o",
                     str(png), "--metrics"]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    img = np.asarray(Image.open(png))
    assert img.shape == (16, 16, 3) and img.max() > 0
    assert metrics["avg_path_len"] >= 1.0
