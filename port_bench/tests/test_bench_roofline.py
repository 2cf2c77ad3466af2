"""The frozen K1 arithmetic equals the program's own (`chip_smoke.py`'s
k1_bound and fold_ops_per_lane) on a small probe state on the CPU."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

from port_bench import harness
from port_bench.reference import scene as ref_scene
from port_bench.roofline import h100, k1

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name", ["tiny", "cornell_box"])
def test_k1_bound_matches_chip_smoke(name, tiny):
    """The throwaway scene has every kind of fold row (spheres, moving
    ones, a rect, a triangle, a medium); the Cornell box rects alone."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from path_tracer_tpu_torch.engine.wq import _pack_atlas_flat
    from path_tracer_tpu_torch.ops import probe
    from path_tracer_tpu_torch.ops import wave_bounce as WB
    from port_bench import scene
    root = tiny[1] if name == "tiny" else harness.ROOT
    cfg = harness.load_module(root / "configs" / f"{name}.py")
    sc, cam = scene.build(cfg, 32, 24, "cpu")
    tables = WB.pack_scene(sc, "cpu")._replace(
        cam=WB.pack_camera(cam, 32, 24, "cpu"), seed=7)
    atlas, _ = _pack_atlas_flat(sc.textures.atlas)
    st, fix, texel, srv = probe.probe_state(tables, cam, 32, 24, atlas,
                                            rows=8, bounces=2, seed=3)
    nbytes, ops = chip_smoke.k1_bound(tables, st, fix, srv)
    rows = ref_scene.fold_rows(cfg)
    lanes = st.ox.numel()
    n_adv = int(((st.alive > 0) & ~((fix.kind != 0) & (srv <= 0))).sum())
    assert lanes * k1.BYTES_PER_LANE == nbytes
    assert n_adv * k1.fold_ops_per_lane(rows) == ops
    assert k1.fold_ops_per_lane(rows) == chip_smoke.fold_ops_per_lane(tables)
    assert k1.bound_s(lanes, n_adv, rows) == max(
        nbytes / chip_smoke.HBM_BYTES_S, ops / chip_smoke.FP32_OPS_S)
    assert (h100.HBM_BYTES_S, h100.FP32_FLOP_S) == (
        chip_smoke.HBM_BYTES_S, chip_smoke.FP32_OPS_S)
