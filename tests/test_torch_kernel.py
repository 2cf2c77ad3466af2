"""The kernels' wrappers and their CUDA kernels, with the port alone (no
JAX, so the card's tests run here too).

On the CPU: the wrapper takes the plain version for CPU tensors and counts
no launch.  On the card (marked `cuda`, skipped without a GPU): the kernel
against its plain version on the same final-scene probe state.  Both round
every float op alike (the kernel is built with -fmad=false, sin/cos/log
are float64 rounded once in both), so the bounds are tight: integer planes
equal on >= 99.5% of lanes, float planes within 4 ulp on >= 99.9% of the
lanes whose win agrees.  Forced to each split of its sphere fold (K
threads a lane), the kernel is bit-equal to the plain version on every
lane and plane, on the final scene and on `probe.tie_scene`, whose equal
sphere keys must go to the lowest index, and with 5 and 6 media
(`probe.media_scene`) through its run-time media count.  Past the
shared-memory variants' caps (24 and 30 media, and `probe.sphere_scene`'s
13,000 static spheres, a fold table over 192 KB) the global-memory variant
is bit-equal too.  The nearest-sphere spike (K2)
is bit-equal to its plain version on the card, at the wrapper's K and
forced to every K of `spike_pmat.SPLITS`, at 64 and 4096 rows,
on the tie table (`make_tie_inputs`) and on degenerate rays
(`make_edge_inputs`).
"""
import pytest
import torch

from path_tracer_tpu_torch.engine.wq import _pack_atlas_flat
from path_tracer_tpu_torch.ops import probe
from path_tracer_tpu_torch.ops import spike_pmat as SP
from path_tracer_tpu_torch.ops import wave_bounce as WB
from path_tracer_tpu_torch.scene.presets import build_final_scene

W, H = 800, 600
KW = dict(t_min=1e-3, max_depth=4, attenuate=False)


def _case(device, rows, build=build_final_scene):
    scene, cam = build(W / H, device=device)
    tables = WB.pack_scene(scene)._replace(
        cam=WB.pack_camera(cam, W, H, device), seed=11)
    atlas, _ = _pack_atlas_flat(scene.textures.atlas)
    st, fix, texel, srv = probe.probe_state(
        tables, cam, W, H, atlas, rows=rows, bounces=3, max_depth=4, seed=5,
        tile_rows=8)
    return tables, st, fix, texel, srv


def test_cpu_tensors_take_the_plain_version():
    tables, st, fix, texel, srv = _case("cpu", rows=8)
    before = WB.wave_bounce.launches
    out = WB.wave_bounce(tables, st, fix, texel, srv, tile_rows=8, **KW)
    assert WB.wave_bounce.launches == before
    plain = WB.wave_bounce_plain(tables, st, fix, texel, srv, **KW)
    agree = probe.agreement(out, plain)
    assert all(agree[k] == 1.0 for k in probe.INT_PLANES), agree
    assert all(agree[k + "_max_ulp"] == 0.0
               for k in probe.FLOAT_PLANES + probe.FIX_PLANES), agree


def test_rows_must_be_a_multiple_of_tile_rows():
    tables, st, fix, texel, srv = _case("cpu", rows=8)
    with pytest.raises(ValueError, match="tile_rows"):
        WB.wave_bounce(tables, st, fix, texel, srv, tile_rows=64, **KW)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    tables, st, fix, texel, srv = _case(cuda_device, rows=64)
    before = WB.wave_bounce.launches
    kern = WB.wave_bounce(tables, st, fix, texel, srv, tile_rows=8, **KW)
    torch.cuda.synchronize()
    assert WB.wave_bounce.launches == before + 1
    plain = WB.wave_bounce_plain(tables, st, fix, texel, srv, **KW)
    agree = probe.agreement(kern, plain)
    for k in probe.INT_PLANES:
        assert agree[k] >= 0.995, agree
    for k in probe.FLOAT_PLANES + probe.FIX_PLANES:
        assert agree[k] >= 0.999, agree


@pytest.mark.cuda
@pytest.mark.parametrize("k", WB.SPLITS)
@pytest.mark.parametrize("scene", ["final", "ties"])
def test_every_split_is_bit_equal_on_card(cuda_device, scene, k):
    build = {"final": build_final_scene, "ties": probe.tie_scene}[scene]
    tables, st, fix, texel, srv = _case(cuda_device, rows=16, build=build)
    kern = WB.wave_bounce(tables, st, fix, texel, srv, tile_rows=8,
                          _split=k, **KW)
    torch.cuda.synchronize()
    plain = WB.wave_bounce_plain(tables, st, fix, texel, srv, **KW)
    agree = probe.agreement(kern, plain)
    assert all(agree[p] == 1.0 for p in probe.INT_PLANES), agree
    assert all(agree[p + "_max_ulp"] == 0.0
               for p in probe.FLOAT_PLANES + probe.FIX_PLANES), agree


@pytest.mark.cuda
@pytest.mark.parametrize("k", WB.SPLITS)
@pytest.mark.parametrize("n_media", [5, 6])
def test_run_time_media_count_is_bit_equal_on_card(cuda_device, n_media, k):
    """Past the 4 templated media counts, the run-time instantiation."""
    build = lambda aspect, device: probe.media_scene(aspect, n_media, device)
    tables, st, fix, texel, srv = _case(cuda_device, rows=16, build=build)
    assert tables.med.shape[1] == n_media
    kern = WB.wave_bounce(tables, st, fix, texel, srv, tile_rows=8,
                          _split=k, **KW)
    torch.cuda.synchronize()
    plain = WB.wave_bounce_plain(tables, st, fix, texel, srv, **KW)
    agree = probe.agreement(kern, plain)
    assert all(agree[p] == 1.0 for p in probe.INT_PLANES), agree
    assert all(agree[p + "_max_ulp"] == 0.0
               for p in probe.FLOAT_PLANES + probe.FIX_PLANES), agree


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["media24", "media30", "spheres13000"])
def test_scene_past_the_caps_is_bit_equal_on_card(cuda_device, scene):
    """More media than the shared-memory variants take, or a fold table
    larger than they stage: the global variant, once refused."""
    build = {"media24": lambda a, device: probe.media_scene(
                 a, WB.MAX_MED + 1, device),
             "media30": lambda a, device: probe.media_scene(a, 30, device),
             "spheres13000": probe.sphere_scene}[scene]
    tables, st, fix, texel, srv = _case(cuda_device, rows=16, build=build)
    assert WB.k1_variant(tables.med.shape[1],
                         tables.fold.shape[0] * 16) == "global"
    before = WB.wave_bounce.launches
    kern = WB.wave_bounce(tables, st, fix, texel, srv, tile_rows=8, **KW)
    torch.cuda.synchronize()
    assert WB.wave_bounce.launches == before + 1
    plain = WB.wave_bounce_plain(tables, st, fix, texel, srv, **KW)
    agree = probe.agreement(kern, plain)
    assert all(agree[p] == 1.0 for p in probe.INT_PLANES), agree
    assert all(agree[p + "_max_ulp"] == 0.0
               for p in probe.FLOAT_PLANES + probe.FIX_PLANES), agree
    with pytest.raises(ValueError, match="K = 1"):
        WB.wave_bounce(tables, st, fix, texel, srv, tile_rows=8, _split=4,
                       **KW)


@pytest.mark.cuda
def test_kernel_rejects_a_wrong_dtype(cuda_device):
    tables, st, fix, texel, srv = _case(cuda_device, rows=8)
    with pytest.raises(ValueError, match="rng"):
        WB.wave_bounce(tables, st._replace(rng=st.rng.int()), fix, texel,
                       srv, tile_rows=8, **KW)


@pytest.mark.cuda
def test_spike_pmat_kernel_matches_plain_on_card(cuda_device):
    args = SP.make_inputs(SP.TILE_ROWS, seed=1, device=cuda_device)
    before = SP.spike_pmat.launches
    t, meta = SP.spike_pmat(*args)
    torch.cuda.synchronize()
    assert SP.spike_pmat.launches == before + 1
    pt, pm = SP.spike_pmat_plain(*args)
    assert torch.equal(t, pt) and torch.equal(meta, pm)


PMAT_CASES = {
    "64 rows": lambda dev: SP.make_inputs(64, seed=0, device=dev),
    "4096 rows": lambda dev: SP.make_inputs(4096, seed=0, device=dev),
    "ties": lambda dev: SP.make_tie_inputs(64, device=dev),
    "edge": lambda dev: SP.make_edge_inputs(device=dev),
}


@pytest.fixture(scope="module")
def pmat_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    out = {}
    for name, make in PMAT_CASES.items():
        args = make(dev)
        out[name] = (args, SP.spike_pmat_plain(*args))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("k", SP.SPLITS)
@pytest.mark.parametrize("case", list(PMAT_CASES))
def test_spike_pmat_every_split_is_bit_equal_on_card(pmat_cases, case, k):
    args, (pt, pm) = pmat_cases[case]
    t, meta = SP.spike_pmat(*args, _split=k)
    torch.cuda.synchronize()
    assert torch.equal(t.view(torch.int32), pt.view(torch.int32))
    assert torch.equal(meta, pm)
    if case == "ties":
        hit = torch.isfinite(t)
        assert hit.float().mean() > 0.95 and (meta[hit] < 4).all()


@pytest.mark.cuda
def test_spike_pmat_rejects_a_split_it_was_not_built_for(cuda_device):
    args = SP.make_inputs(SP.TILE_ROWS, seed=1, device=cuda_device)
    with pytest.raises(ValueError, match="not one of"):
        SP.spike_pmat(*args, _split=3)
