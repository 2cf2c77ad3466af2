"""The `next_week_final` configuration against the program it was
recorded from, on the CPU: its frozen calls pack to the program's own
tables, the reference counts the program's fold rows (1,008 sphere rows,
one moving; 2,408 rect rows; 8 triangle rows of padding; 2 media), and
at 40x40, 2 samples a pixel and the configuration's depth 40 the program
(K1's plain version) and the plain reference agree on every pixel and on
the segments."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import harness, scene, seeds
from port_bench.reference import checks
from port_bench.reference import scene as ref_scene

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1013


@pytest.fixture(scope="module")
def cfg():
    return harness.config(harness.bench(), "next_week_final")


@pytest.fixture(scope="module")
def program():
    from path_tracer_tpu_torch.scene import presets as P
    mp = pytest.MonkeyPatch()
    mp.setattr(P, "REFERENCE_IMAGES", "")
    sb, cam = P.next_week_final_builder()
    mp.undo()
    return sb.build(device=CPU), cam


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in _leaves(x)]


def test_frozen_calls_pack_to_the_programs_tables(cfg, program):
    w, h = cfg.CONFIG["resolution"]
    assert (w, h, cfg.CONFIG["spp"], cfg.CONFIG["max_depth"]) == (800, 800,
                                                                  40, 40)
    got_scene, got_cam = scene.build(cfg, w, h, CPU)
    want_scene, want_cam = program
    got, want = _leaves((got_scene, got_cam)), _leaves((want_scene, want_cam))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_reference_counts_the_programs_fold_rows(cfg, program):
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    tables = WB.pack_scene(program[0], CPU)
    static = moving = start = 0
    for static_end, end in tables.sph_segs.tolist():
        static += static_end - start
        moving += end - static_end
        start = end
    want = dict(static=static, moving=moving, rect=tables.rect.shape[1],
                tri=tables.tri.shape[1], med=tables.med.shape[1])
    assert ref_scene.fold_rows(cfg) == want == dict(
        static=1007, moving=1, rect=2408, tri=8, med=2)


def test_program_and_reference_agree_at_40x40(cfg):
    from path_tracer_tpu_torch.engine.wq import render_wq
    w, h, spp = 40, 40, 2
    depth = cfg.CONFIG["max_depth"]
    seed = seeds.frame(SEED, "frame", 0)
    sc, cam = scene.build(cfg, w, h, CPU)
    img, segs, _, _ = render_wq(sc, cam, w, h, spp, max_depth=depth,
                                seed=seed, return_stats=True, device=CPU)
    pix = np.arange(w * h, dtype=np.int64)
    tb = ref_scene.build(cfg, CPU)
    rcam = ref_scene.camera(cfg.CONFIG["camera"], w / h)
    ans = [checks.FrameAnswer(seed, pix, None, 0.0)]
    ref, ref_segs = checks.frame_values(cfg, tb, rcam, w, h, spp, depth,
                                        ans, False)
    vals = img.reshape(-1, 3).numpy().astype(np.float64)
    ref = ref[0].astype(np.float64)
    gap = np.abs(vals - ref) / np.maximum(np.abs(ref), checks.FLOOR)
    assert float(gap.max()) <= 1e-6
    assert segs / (w * h * spp) == ref_segs
