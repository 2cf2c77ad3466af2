"""The port's checkpointed render on the CPU, and its checkpoint files
against the reference package's (no reference render here).

Mirrors tests/test_app.py's work-queue checkpoint tests: an interrupted
and resumed render equals an uninterrupted one with the same range
boundaries bit for bit, and lies within 2e-4 of one `render_wq` of all
samples (range sums reassociate the per-pixel sum).  The files are the
reference package's format, so a checkpoint either package writes, the
other reads.
"""
import json
import os

import numpy as np
import pytest

from path_tracer_tpu.engine import checkpoint as JCK
from path_tracer_tpu_torch import cli
from path_tracer_tpu_torch.config import RENDERERS
from path_tracer_tpu_torch.engine import checkpoint as CK
from path_tracer_tpu_torch.engine.wq import render_wq
from path_tracer_tpu_torch.scene.presets import THREE_SPHERES

W, H, SPP, DEPTH = 32, 16, 6, 4
NAME = "three_spheres"


def meta(seed=0, **kw):
    return dict({"scene": NAME, "width": W, "height": H, "max_depth": DEPTH,
                 "seed": seed, "t_min": 1e-3, "attenuate_emission": False,
                 "renderer": "wq"}, **kw)


@pytest.fixture(scope="module")
def scene():
    return THREE_SPHERES.build(device="cpu")


def render(scene, d, spp, every=2, **kw):
    return CK.render_checkpointed(*scene, W, H, spp, DEPTH, ckpt_dir=d,
                                  checkpoint_every=every, scene_name=NAME,
                                  device="cpu", **kw)


def test_resume_is_bit_exact_and_matches_render_wq(scene, tmp_path):
    d = str(tmp_path / "ckpt")
    render(scene, d, 4)
    acc, done = CK.load_checkpoint(d, meta())
    assert done == 4 and acc.shape == (W * H, 3) and acc.dtype == np.float32
    resumed = render(scene, d, SPP).numpy()
    unint = render(scene, str(tmp_path / "c2"), SPP).numpy()
    np.testing.assert_array_equal(resumed.view(np.uint32),
                                  unint.view(np.uint32))
    with np.load(os.path.join(d, "accum.npz")) as a, \
            np.load(str(tmp_path / "c2" / "accum.npz")) as b:
        np.testing.assert_array_equal(a["acc"].view(np.uint32),
                                      b["acc"].view(np.uint32))
    full = render_wq(*scene, W, H, SPP, max_depth=DEPTH, device="cpu")
    np.testing.assert_allclose(resumed, full.numpy(), atol=2e-4)


def test_mismatched_seed_is_ignored(scene, tmp_path):
    d = str(tmp_path / "ckpt")
    render(scene, d, 2, every=1)
    assert CK.load_checkpoint(d, meta())[1] == 2
    acc, done = CK.load_checkpoint(d, meta(seed=99))
    assert acc is None and done == 0


@pytest.mark.parametrize("damage", ["garbage", "truncated", "wrong_shape"])
def test_corrupt_accumulator_starts_over(scene, tmp_path, damage):
    d = str(tmp_path / "ckpt")
    render(scene, d, 2, every=2)
    path = os.path.join(d, "accum.npz")
    if damage == "garbage":
        with open(path, "wb") as f:
            f.write(b"not an npz file")
    elif damage == "truncated":
        data = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(data[: len(data) // 2])
    else:
        np.savez(path, acc=np.zeros((W * H, 4), np.float32))
    assert CK.load_checkpoint(d, meta()) == (None, 0)
    again = render(scene, d, 2, every=2)       # starts over from sample 0
    fresh = render(scene, str(tmp_path / "fresh"), 2, every=2)
    np.testing.assert_array_equal(again.numpy(), fresh.numpy())


def test_checkpoint_with_more_samples_than_asked_starts_over(scene,
                                                             tmp_path):
    d = str(tmp_path / "ckpt")
    render(scene, d, 4)
    img = render(scene, d, 2)
    fresh = render(scene, str(tmp_path / "fresh"), 2)
    np.testing.assert_array_equal(img.numpy(), fresh.numpy())
    assert CK.load_checkpoint(d, meta())[1] == 2


@pytest.mark.parametrize("renderer", RENDERERS)
def test_cli_checkpoint_identity_names_the_wq_renderer(renderer, tmp_path):
    """Every --renderer name runs the work-queue renderer, and the
    checkpoint says so in the reference's terms."""
    d = str(tmp_path / "ckpt")
    assert cli.main(["render", "--scene", NAME, "--width", str(W),
                     "--height", str(H), "--spp", "2", "--max-depth",
                     str(DEPTH), "--renderer", renderer, "--device", "cpu",
                     "--checkpoint-dir", d, "--checkpoint-every", "1",
                     "-o", str(tmp_path / "x.png")]) == 0
    with open(os.path.join(d, "meta.json")) as f:
        assert json.load(f) == dict(meta(), spp_done=2)
    assert JCK.load_checkpoint(d, meta())[1] == 2


def test_reference_checkpoint_is_read_by_the_port(tmp_path):
    d = str(tmp_path / "ckpt")
    acc = np.random.RandomState(0).rand(W * H, 3).astype(np.float32)
    JCK._save_atomic(d, acc, dict(meta(), spp_done=3))
    got, done = CK.load_checkpoint(d, meta())
    assert done == 3
    np.testing.assert_array_equal(got, acc)
    assert CK.load_checkpoint(d, meta(seed=1)) == (None, 0)


def test_port_checkpoint_is_read_by_the_reference(scene, tmp_path):
    d = str(tmp_path / "ckpt")
    render(scene, d, 2, every=2)
    with open(os.path.join(d, "meta.json")) as f:
        assert json.load(f) == dict(meta(), spp_done=2)
    got, done = JCK.load_checkpoint(d, meta())
    assert done == 2
    ours, _ = CK.load_checkpoint(d, meta())
    np.testing.assert_array_equal(np.asarray(got), ours)
    assert JCK.load_checkpoint(d, meta(max_depth=9)) == (None, 0)
