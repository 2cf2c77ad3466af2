"""The paths that run the oracle engines, on the CPU: the command line's
renderers, the checkpoint's "jnp" loop and `checked_render`, with the
reference package's checkpoint loop and `checked_render` as the yardstick.

* The CLI's `--renderer wavefront|fused|perf|parity` each write the PNG
  of what the engine's function renders for the same arguments (bit for
  bit); `auto` is `wavefront` on the CPU and `wq` on CUDA (the reference's
  `resolve_auto_renderer`), and `bench` follows it.
* `render_checkpointed(renderer="jnp")` (three_spheres 32x16, depth 4,
  ranges of 1 spp in 2 pixel tiles, a save every 2): interrupted at 2 spp
  and resumed to 4 it equals an uninterrupted 4 bit for bit; "renderer"
  is in the identity; the reference's jnp render of the same frame lies
  inside test_wq.py's final-scene envelope of it (at most 3% of pixels
  beyond 5e-3: the jitted reference contracts a*b+c into FMA), and each
  package reads the other's jnp checkpoint.
* `checked_render` on cornell_box (8x8, 2 spp, depth 6) equals the
  reference's checkify render within that envelope and raises
  FloatingPointError naming the bounce on a scene with a NaN albedo, and
  IndexError on a material id past the table.

Every reference call is made once, in the module's fixture.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from path_tracer_tpu.engine import checkpoint as JCK
from path_tracer_tpu.scene.presets import CORNELL_BOX as JCORNELL
from path_tracer_tpu.scene.presets import THREE_SPHERES as JTHREE
from path_tracer_tpu.utils import debug as JD
from path_tracer_tpu_torch import cli
from path_tracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from path_tracer_tpu_torch.engine import checkpoint as CK
from path_tracer_tpu_torch.engine import integrator as TI
from path_tracer_tpu_torch.scene.presets import THREE_SPHERES
from path_tracer_tpu_torch.utils.debug import checked_render
from path_tracer_tpu_torch.utils.image import tonemap

W, H, SPP, DEPTH = 32, 16, 4, 4
NAME = "three_spheres"
LANES = 256                       # max_lanes: ranges of 1 spp, 2 tiles
CW = CH = 8
CSPP, CDEPTH = 2, 6


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def meta(**kw):
    return dict({"scene": NAME, "width": W, "height": H, "max_depth": DEPTH,
                 "seed": 0, "t_min": 1e-3, "attenuate_emission": False,
                 "renderer": "jnp"}, **kw)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    js, jc = JTHREE.build()
    ck = np.asarray(JCK.render_checkpointed(
        js, jc, W, H, SPP, DEPTH, ckpt_dir=d, checkpoint_every=2,
        scene_name=NAME, max_lanes=LANES, renderer="jnp"))
    cs, cc = JCORNELL.build()
    checked = np.asarray(JD.checked_render(cs, cc, CW, CH, CSPP,
                                           max_depth=CDEPTH))
    return dict(ckpt=(ck, d), checked=(cs, cc, checked))


@pytest.fixture(scope="module")
def three():
    return THREE_SPHERES.build(device="cpu")


def _ck(scene, d, spp, **kw):
    return CK.render_checkpointed(*scene, W, H, spp, DEPTH, ckpt_dir=d,
                                  checkpoint_every=2, scene_name=NAME,
                                  max_lanes=LANES, renderer="jnp",
                                  device="cpu", **kw)


# ---- the command line ---------------------------------------------------

@pytest.mark.parametrize("renderer", ["wavefront", "fused", "perf",
                                      "parity"])
def test_cli_renderer_writes_the_engines_frame(renderer, three, tmp_path,
                                               monkeypatch):
    png = str(tmp_path / "x.png")
    saved = []
    monkeypatch.setattr(cli, "save_png",
                        lambda path, img: saved.append((path, img)))
    assert cli.main(["render", "--scene", NAME, "--width", "16", "--height",
                     "8", "--spp", "2", "--max-depth", "3", "--renderer",
                     renderer, "--device", "cpu", "-o", png]) == 0
    fn = getattr(TI, f"render_{renderer}")
    want = fn(*three, 16, 8, 2, 3, device="cpu").numpy()
    ((path, img),) = saved
    assert path == png
    np.testing.assert_array_equal(img, want)
    assert tonemap(img).shape == (8, 16, 3)


def test_auto_rule_and_bench(capsys, monkeypatch):
    assert cli.resolve_auto_renderer(torch.device("cpu")) == "wavefront"
    assert cli.resolve_auto_renderer(torch.device("cuda")) == "wq"
    # bench renders its preset at this file's size: the test checks the
    # renderer it ran and the line it printed
    monkeypatch.setitem(cli.PRESETS, NAME, cli.PRESETS[NAME]._replace(
        width=W, height=H))
    ran = []
    real = cli.render_wavefront
    monkeypatch.setattr(cli, "render_wavefront",
                        lambda *a, **k: ran.append(1) or real(*a, **k))
    assert cli.main(["bench", "--scene", NAME, "--spp", "1",
                     "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["renderer"] == "wavefront" and out["value"] > 0
    assert len(ran) == 2               # the warm-up and the timed run


# ---- the checkpoint's jnp loop ------------------------------------------

def test_jnp_resume_is_bit_exact(three, tmp_path):
    d = str(tmp_path / "ckpt")
    _ck(three, d, 2)
    assert CK.load_checkpoint(d, meta())[1] == 2
    resumed = _ck(three, d, SPP)
    with open(os.path.join(d, "meta.json")) as f:
        assert json.load(f) == dict(meta(), spp_done=SPP)
    fresh = _ck(three, str(tmp_path / "fresh"), SPP)
    np.testing.assert_array_equal(resumed.numpy(), fresh.numpy())
    # the renderer is in the identity: a wq render starts over
    assert CK.load_checkpoint(d, meta(renderer="wq")) == (None, 0)
    with pytest.raises(ValueError, match="renderer"):
        CK.render_checkpointed(*three, W, H, SPP, renderer="nope",
                               device="cpu")


def test_jnp_checkpoint_matches_the_reference(refs, three, tmp_path):
    ref, ref_dir = refs["ckpt"]
    img = _ck(three, str(tmp_path / "c"), SPP).numpy()
    d = np.abs(img - ref).max(axis=-1)
    assert float((d > 5e-3).mean()) <= 0.03, float(d.max())
    # each package reads the other's jnp checkpoint
    acc, done = CK.load_checkpoint(ref_dir, meta())
    assert done == SPP and acc.shape == (W * H, 3)
    assert JCK.load_checkpoint(str(tmp_path / "c"), meta())[1] == SPP


# ---- checked_render -----------------------------------------------------

def _port_cornell(refs):
    cs, cc, _ = refs["checked"]
    return (scene_from_numpy(_np_tree(cs), "cpu"),
            camera_from_numpy(_np_tree(cc)))


def test_checked_render_matches_the_reference(refs):
    scene, cam = _port_cornell(refs)
    img = checked_render(scene, cam, CW, CH, CSPP, max_depth=CDEPTH,
                         device="cpu").numpy()
    ref = refs["checked"][2]
    assert img.shape == (CH, CW, 3) and np.isfinite(img).all()
    d = np.abs(img - ref).max(axis=-1)
    assert float((d > 5e-3).mean()) <= 0.03, float(d.max())


def test_checked_render_raises_on_a_nan(refs):
    scene, cam = _port_cornell(refs)
    c1 = scene.textures.c1
    bad = type(c1)(torch.full_like(c1.x, float("nan")), c1.y, c1.z)
    scene = scene._replace(textures=scene.textures._replace(c1=bad))
    with pytest.raises(FloatingPointError, match="bounce"):
        checked_render(scene, cam, CW, CH, 1, max_depth=CDEPTH,
                       device="cpu")


def test_checked_render_raises_on_a_bad_index(refs):
    scene, cam = _port_cornell(refs)
    rects = scene.rects
    scene = scene._replace(rects=rects._replace(
        mat=torch.full_like(rects.mat, 1000)))
    with pytest.raises(IndexError, match="materials"):
        checked_render(scene, cam, CW, CH, 1, max_depth=CDEPTH,
                       device="cpu")
