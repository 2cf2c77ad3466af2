"""The port's image output against the reference package's
`utils/image.py`: tone mapping and PPM text equal, and the PNG the
port's standard-library writer makes decodes to the pixels of the one the
reference writes (its native writer where `make -C native` built it, else
PIL).

The seeded framebuffer holds zeros, values in (0, 1) and values above 1,
so the gamma, the clamp at 0.999 and the flip are all exercised.
"""
import numpy as np
import pytest
from PIL import Image

from path_tracer_tpu.utils import image as JIM
from path_tracer_tpu_torch.utils import image as IM


@pytest.fixture
def fb():
    rs = np.random.RandomState(3)
    fb = rs.uniform(0.0, 1.5, (9, 7, 3)).astype(np.float32)
    fb[rs.rand(9, 7, 3) < 0.2] = 0.0
    assert (fb == 0).any() and ((fb > 0) & (fb < 1)).any() and (fb > 1).any()
    return fb


def test_tonemap_equals_the_reference(fb):
    out = IM.tonemap(fb)
    assert out.dtype == np.uint8 and out.shape == fb.shape
    np.testing.assert_array_equal(out, JIM.tonemap(fb))


def test_tonemap_of_a_tensor(fb):
    import torch
    np.testing.assert_array_equal(IM.tonemap(torch.from_numpy(fb)),
                                  JIM.tonemap(fb))


def test_dump_ppm_equals_the_reference(fb):
    txt = IM.dump_ppm(fb)
    assert txt == JIM.dump_ppm(fb)
    lines = txt.splitlines()
    assert lines[:3] == ["P3", "7 9", "255"] and len(lines) == 3 + 9 * 7


@pytest.mark.parametrize("shape", [(9, 7), (1, 1), (3, 200)])
def test_save_png_round_trip(shape, tmp_path):
    rs = np.random.RandomState(sum(shape))
    fb = rs.uniform(0.0, 1.5, shape + (3,)).astype(np.float32)
    path = str(tmp_path / "out.png")
    IM.save_png(path, fb)
    back = Image.open(path)
    assert back.mode == "RGB" and back.size == shape[::-1]
    np.testing.assert_array_equal(np.asarray(back), IM.tonemap(fb))


def test_png_decodes_as_the_reference_writers(fb, tmp_path):
    ours, ref = str(tmp_path / "ours.png"), str(tmp_path / "ref.png")
    IM.save_png(ours, fb)
    JIM.save_png(ref, fb)
    np.testing.assert_array_equal(np.asarray(Image.open(ours)),
                                  np.asarray(Image.open(ref)))
