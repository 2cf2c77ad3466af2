"""The windowed driver's refill kernel (`ops.refill.refill`) against its
plain version `engine.wq.refill_plain`, with the port alone (no JAX, so the
card's tests run here too).

On the CPU: the module imports with no nvcc and no CUDA; CPU carries take
`refill_plain` and the kernel's launch counter does not move; the kernel
refuses CPU tensors; `wq_window_fb.refill_noop` equals a recount of the
eager driver's refills whose counter did not move; `_distinct` clones
exactly the planes that share memory with another.

On the card (marked `cuda`, skipped without a GPU): every refill of real
windows, checked bit for bit against `refill_plain` on every plane of the state
and the banks, the counter and the no-op count.  The windows are the final
scene's at 800x480, 10 spp in chunks of 2 (both bank slots full; the queue
ending inside a refill; refills with nothing left to grant), the Cornell
box with its light an image texture (dead lanes with a pending EMIT
fixup), and a ragged shard of the final scene (pixel and sample bases,
two chunks a pixel of three).  Then a whole 800x480x10 `render_wq`
through CUDA graphs equals the one driven by `refill_plain`, and one warm
preview pass of the Cornell box is 64 refill launches, 31 of its 32
refills granting nothing.
"""
import subprocess
import sys
from collections import OrderedDict

import pytest
import torch

from path_tracer_tpu_torch.engine import wq
from path_tracer_tpu_torch.ops import refill as RF
from path_tracer_tpu_torch.scene import presets as P
from path_tracer_tpu_torch.scene.builder import SceneBuilder

CPU = torch.device("cpu")


def test_module_imports_without_nvcc_or_cuda():
    code = ("import torch; from path_tracer_tpu_torch.ops import build, "
            "refill; assert refill.refill.launches == 0; "
            "assert not build._loaded; print(torch.cuda.is_available())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "CUDA_HOME": "/",
                              "PATH": "/nonexistent",
                              "PYTHONPATH": ":".join(sys.path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


@pytest.fixture(scope="module")
def scenes():
    return {"cornell": P.CORNELL_BOX.build(CPU),
            "textured": P.TEXTURED_MOTION.build(CPU)}


def _recount(monkeypatch):
    """Each `refill_plain` call of the driver: whether its counter moved."""
    moved = []
    real = wq.refill_plain

    def counted(c, st, ex, counter, fx, noop):
        out = real(c, st, ex, counter, fx, noop)
        moved.append(bool(out[2] != counter))
        return out

    monkeypatch.setattr(wq, "refill_plain", counted)
    return moved


CPU_CASES = {
    "cornell": dict(scene="cornell", w=32, h=32, spp_loc=4, chunk=2),
    "textured": dict(scene="textured", w=32, h=24, spp_loc=2, chunk=2),
    "shard": dict(scene="textured", w=32, h=24, spp_loc=4, chunk=2,
                  n_pix_loc=300, pix_base=200, samp_base=4, valid_pix=250,
                  valid_cpp=1),
}


def _cpu_run(scenes, case, seed=5):
    kw = dict(CPU_CASES[case])
    sc, cam = scenes[kw.pop("scene")]
    w, h = kw.pop("w"), kw.pop("h")
    kw.setdefault("n_pix_loc", w * h)
    return wq.wq_window_fb(sc, cam, w, h, window=3, max_depth=8,
                           attenuate=False, t_min=1e-3, tile_rows=1,
                           seed=seed, device=CPU, **kw)


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_cpu_carries_take_the_plain_refill(scenes, monkeypatch, case):
    moved = _recount(monkeypatch)
    before = RF.refill.launches
    _cpu_run(scenes, case)
    assert len(moved) > 0 and RF.refill.launches == before


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_refill_noop_counts_the_refills_that_granted_nothing(
        scenes, monkeypatch, case):
    moved = _recount(monkeypatch)
    monkeypatch.setattr(wq.wq_window_fb, "refill_noop", 0)
    out = _cpu_run(scenes, case)
    assert wq.wq_window_fb.refill_noop == moved.count(False)
    assert 0 < moved.count(False) < len(moved)
    assert len(moved) % 3 == 0 and len(moved) <= out[2]


def test_kernel_refuses_cpu_tensors(scenes):
    sc, cam = scenes["cornell"]
    c = wq.window_call(sc, cam, 16, 16, n_pix_loc=256, chunk=1, cpp=1,
                       n_chunks=256, vcpp=1, pix_base=0, samp_base=0,
                       window=3, max_depth=8, attenuate=False, t_min=1e-3,
                       tile_rows=1, seed=1, device=CPU)
    cy = wq.zero_carry(2, 256, CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        RF.refill(c, cy.st, cy.ex, cy.counter, cy.fx,
                  torch.zeros((), dtype=torch.int64))


def test_distinct_clones_only_shared_planes():
    z = torch.zeros(4, 128)
    kept = torch.zeros(4, 128)
    big = torch.zeros(8, 128)
    planes = [z, z, kept, big[:4], big[4:], big[2:6], torch.ones(4, 128)]
    out = RF._distinct([kept], planes)
    ptrs = [t.data_ptr() for t in out]
    assert ptrs[0] == z.data_ptr() and ptrs[3] == big.data_ptr()
    assert ptrs[4] == big[4:].data_ptr() and ptrs[6] == planes[6].data_ptr()
    assert ptrs[1] != z.data_ptr() and ptrs[2] != kept.data_ptr()
    assert ptrs[5] != big[2:6].data_ptr()
    assert len(set(ptrs)) == len(ptrs)
    assert all(torch.equal(a, b) for a, b in zip(out, planes))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

W, H = 800, 480


def _lit_cornell(device):
    """The Cornell box with its light an image texture: paths that end on
    it leave an EMIT fixup pending on a dead lane."""
    sb = SceneBuilder()
    red = sb.lambertian((0.65, 0.05, 0.05))
    white = sb.lambertian((0.73, 0.73, 0.73))
    green = sb.lambertian((0.12, 0.45, 0.15))
    light = sb.light(sb.image_texture(P._procedural_logo()))
    sb.add_yz_rect(0, 555, 0, 555, 555, green)
    sb.add_yz_rect(0, 555, 0, 555, 0, red)
    sb.add_xz_rect(113, 443, 127, 432, 554, light)
    sb.add_xz_rect(0, 555, 0, 555, 0, white)
    sb.add_xz_rect(0, 555, 0, 555, 555, white)
    sb.add_xy_rect(0, 555, 0, 555, 555, white)
    sb.add_box((130, 0, 65), (295, 165, 230), white)
    sb.add_box((265, 0, 295), (430, 330, 460), white)
    _, cam = P.CORNELL_BOX.build("cpu")
    return sb.build(device=device), cam


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the refill kernel has no CPU mode")
    dev = torch.device("cuda")
    return dict(dev=dev, final=P.build_final_scene(W / H, device=dev),
                box=P.CORNELL_BOX.build(dev), lit=_lit_cornell(dev))


def _bits(t):
    t = t.detach()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _equal(a, b):
    return _bits(a).shape == _bits(b).shape and torch.equal(_bits(a),
                                                            _bits(b))


def _checked(monkeypatch, seen):
    """Every refill of the driver on the card: the kernel on the driver's
    own carry (shared zero planes and all) held bit-equal to `refill_plain` on
    the same inputs; `seen` counts the cases its inputs hold."""
    def both(c, st, ex, counter, fx, noop):
        want = wq.refill_plain(c, st, ex, counter, fx, noop)  # writes none
        dead = st.alive <= 0.0
        full = (ex.bpix0 >= 0.0) & (ex.bpix1 >= 0.0) & (st.pix >= 0.0)
        elig = dead & (fx.kind != 2.0) & ~full
        navail = int(c.n_chunks - counter)
        n_elig = int(elig.sum())
        seen["emit_dead"] += int((dead & (fx.kind == 2.0)).sum())
        seen["both_full"] += int((dead & full).sum())
        seen["queue_ends"] += int(0 < navail < n_elig)
        seen["noop"] += int(navail == 0)
        seen["calls"] += 1
        got = RF.refill(c, st, ex, counter, fx, noop)
        for name, a, b in zip(st._fields + ex._fields, [*want[0], *want[1]],
                              [*got[0], *got[1]]):
            assert _equal(a, b), (seen["calls"], name)
        assert _equal(want[2], got[2]) and _equal(want[3], got[3])
        return got

    monkeypatch.setattr(wq, "_replays", lambda dev: False)
    monkeypatch.setattr(wq, "refill_lanes", both)


def _run(card, scene, w, h, **kw):
    sc, cam = card[scene]
    kw.setdefault("n_pix_loc", w * h)
    return wq.wq_window_fb(sc, cam, w, h, window=wq.DEF_WINDOW, max_depth=50,
                           attenuate=False, t_min=1e-3,
                           tile_rows=wq.DEF_TILE_ROWS, seed=2 ** 31 + 7,
                           device=card["dev"], **kw)


CARD_CASES = {
    # 10 spp in chunks of 2: lanes take several chunks a window
    "final_scene": (("final", W, H), dict(spp_loc=10, chunk=2),
                    ("both_full", "queue_ends", "noop")),
    "lit_cornell": (("lit", 200, 200), dict(spp_loc=2, chunk=1),
                    ("emit_dead", "queue_ends", "noop")),
    # a ragged shard: 3 chunks a pixel, 2 of them granted, 90,000 pixels
    "shard": (("final", W, H), dict(n_pix_loc=96_000, spp_loc=30, chunk=10,
                                    pix_base=200_000, samp_base=30,
                                    valid_pix=90_000, valid_cpp=2),
              ("queue_ends", "noop")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_is_bit_equal_to_refill_on_real_windows(card, monkeypatch,
                                                       case):
    args, kw, cases = CARD_CASES[case]
    seen = dict.fromkeys(("emit_dead", "both_full", "queue_ends", "noop",
                          "calls"), 0)
    _checked(monkeypatch, seen)
    before = RF.refill.launches
    _run(card, *args, **kw)
    torch.cuda.synchronize()
    assert seen["calls"] > 0
    assert RF.refill.launches - before == 2 * seen["calls"]
    assert all(seen[k] > 0 for k in cases), seen


def _render(card, seed):
    sc, cam = card["final"]
    out = wq.render_wq(sc, cam, W, H, 10, seed=seed, return_stats=True,
                       device=card["dev"])
    torch.cuda.synchronize()
    return [out[0].cpu().numpy().tobytes(), *out[1:]]


@pytest.mark.cuda
def test_render_through_graphs_equals_the_twin_driven_render(card,
                                                             monkeypatch):
    """800x480x10 through CUDA graphs: image, segments, bounces and
    lane-steps equal with the kernel and with `refill_plain` in its
    place."""
    runs = {}
    for name in ("kernel", "twin"):
        if name == "twin":
            monkeypatch.setattr(wq, "refill_lanes", wq.refill_plain)
        monkeypatch.setattr(wq, "_plans", OrderedDict())
        replays = wq.wq_window_fb.replays
        runs[name] = [_render(card, s) for s in (3, 3, 2 ** 32 - 5)]
        assert wq.wq_window_fb.replays > replays
    assert runs["kernel"] == runs["twin"]
    assert runs["kernel"][0] == runs["kernel"][1] != runs["kernel"][2]


@pytest.mark.cuda
def test_a_preview_pass_is_64_refill_launches_31_refills_granting_nothing(
        card, monkeypatch):
    sc, cam = card["box"]
    monkeypatch.setattr(wq, "_plans", OrderedDict())
    render = lambda seed: wq.render_wq(sc, cam, 600, 600, 1, seed=seed,
                                       device=card["dev"])
    for seed in (1, 2):              # the first captures each kind
        render(seed)
    launches, noop = RF.refill.launches, wq.wq_window_fb.refill_noop
    replays = wq.wq_window_fb.replays
    render(3)
    torch.cuda.synchronize()
    assert wq.wq_window_fb.replays - replays >= 1     # the refill window
    assert RF.refill.launches - launches == 64
    assert wq.wq_window_fb.refill_noop - noop == 31
