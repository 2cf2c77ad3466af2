"""The windowed driver's texel-service kernel (`ops.texel.texel`) against
its plain version `engine.wq.texel_service`, with the port alone (no JAX,
so the card's tests run here too).

The kernel computes one rule a lane (`_rule` below, in numpy, with the
kernel's unrotated prefixes): a fixup is pending where kind != 0; a lane's
rank is its exclusive rank among its row's pending lanes in lane order
rotated to start at (k * 37) % 128; a row with more than S_SLOTS pending
lanes is heavy and ranks among the heavy rows in row order rotated to
start at (k * 997) % rows; a pending lane is served if it ranks under
S_SLOTS or its heavy row ranks under max(rows // 8, 1), and takes
atlas[clamp(trunc(idx), 0, n_atlas - 1)]; every other lane takes 0.

On the CPU: the module imports with no nvcc and no CUDA; the rule gives
`texel_service`'s bits on edge states (one row, more heavy rows than the
cap, a full row, the row rotation next to the last row, nothing pending,
negative and non-integral indices, a full-width frame) and on every
bounce of real 32-bounce windows; CPU carries take `texel_service` through
`wq.texel_lanes`, counting as `count_nonzero` does, and the kernel's
launch counter does not move; the kernel refuses CPU tensors.

On the card (marked `cuda`, skipped without a GPU): the kernel bit-equal
to `texel_service` on the same edge states, its counts equal to
`count_nonzero`'s; on every bounce of real windows (every k of a
32-bounce window) of the textured preset and of the final scene; a
captured window's replay gives its eager body's bits, counters and two
launches a bounce; a render through graphs equals one driven by the plain
service, image, statistics and counters, with two launches a bounce.
"""
import subprocess
import sys
from collections import OrderedDict

import numpy as np
import pytest
import torch

from path_tracer_tpu_torch.engine import wq
from path_tracer_tpu_torch.ops import probe
from path_tracer_tpu_torch.ops import texel as TX
from path_tracer_tpu_torch.ops import wave_bounce as WB
from path_tracer_tpu_torch.scene import presets as P

CPU = torch.device("cpu")
N_ATLAS = probe.TEXEL_ATLAS
EDGES = probe.TEXEL_EDGES
TEXELS = ("texel_pending", "texel_stalled")


def test_module_imports_without_nvcc_or_cuda():
    code = ("import torch; from path_tracer_tpu_torch.ops import build, "
            "texel; from path_tracer_tpu_torch.engine import wq; "
            "assert texel.texel.launches == 0; "
            "assert not build._loaded; print(torch.cuda.is_available())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "CUDA_HOME": "/",
                              "PATH": "/nonexistent",
                              "PYTHONPATH": ":".join(sys.path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_kernel_takes_the_services_slot_count():
    assert TX.SLOTS == wq.S_SLOTS


def _rule(kind, idx, k, atlas):
    """(texel, srv, pending, served) by the kernel's rule, in numpy: ranks
    in rotated order from unrotated exclusive prefixes, P[x] - P[o] from
    the rotation's start o on, total - P[o] + P[x] before it."""
    rows = kind.shape[0]
    need = kind != 0
    n = need.sum(1)
    heavy = n > wq.S_SLOTS
    p = np.concatenate([[0], np.cumsum(heavy)])
    rbo, r = (k * 997) % rows, np.arange(rows)
    hrank = np.where(r >= rbo, p[r] - p[rbo], p[-1] - p[rbo] + p[r])
    full = heavy & (hrank < max(rows // 8, 1))
    pc = np.concatenate([np.zeros((rows, 1), np.int64), np.cumsum(need, 1)],
                        1)
    bo, lane = (k * 37) % wq.LANE, np.arange(wq.LANE)
    lrank = np.where(lane >= bo, pc[:, :-1] - pc[:, bo:bo + 1],
                     n[:, None] - pc[:, bo:bo + 1] + pc[:, :-1])
    served = need & ((lrank < wq.S_SLOTS) | full[:, None])
    i = np.clip(np.trunc(idx).astype(np.int64), 0, atlas.shape[0] - 1)
    return (np.where(served, atlas[i], 0).astype(np.int32),
            served.astype(np.float32), int(need.sum()), int(served.sum()))


def _atlas(rs):
    return rs.randint(0, 1 << 24, N_ATLAS).astype(np.int32)


def _fix(kind, idx, device):
    z = torch.zeros(kind.shape, dtype=torch.float32, device=device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return WB.FixState(t(kind), t(idx), z, z, z)


@pytest.mark.parametrize("case", EDGES)
def test_rule_gives_the_plain_services_bits_on_edge_states(case):
    kind, idx, ks = probe.texel_edge(case)
    atlas = _atlas(np.random.RandomState(99))
    fx = _fix(kind, idx, CPU)
    flat = torch.from_numpy(atlas)
    seen = []
    for k in ks:
        texel, srv = wq.texel_service(fx, k, flat, N_ATLAS)
        want = _rule(kind, idx, k, atlas)
        np.testing.assert_array_equal(texel.numpy(), want[0])
        np.testing.assert_array_equal(srv.numpy().view(np.int32),
                                      want[1].view(np.int32))
        seen.append(want[2:])
    if case == "none_pending":
        assert all(s == (0, 0) for s in seen)
    else:
        assert all(0 < s <= p for p, s in seen)
    if case in ("heavy_over_cap", "frame_width"):
        assert any(s < p for p, s in seen)        # some lanes stall
        heavy = int(((kind != 0).sum(1) > wq.S_SLOTS).sum())
        assert heavy > max(kind.shape[0] // 8, 1)


def test_cpu_carries_take_texel_service_and_count_as_count_nonzero(
        monkeypatch):
    """Every bounce of a CPU render goes through `texel_service`; the
    rule holds on each (every k of 32-bounce windows) and the counters
    are the sums of `count_nonzero`'s."""
    scene, cam = P.TEXTURED_MOTION.build(CPU)
    calls = []
    real = wq.texel_service

    def checked(fx, k, atlas_flat, n_atlas):
        texel, srv = real(fx, k, atlas_flat, n_atlas)
        want = _rule(fx.kind.numpy(), fx.idx.numpy(), k, atlas_flat.numpy())
        assert np.array_equal(texel.numpy(), want[0])
        assert np.array_equal(srv.numpy(), want[1])
        calls.append((k, *want[2:]))
        return texel, srv

    monkeypatch.setattr(wq, "texel_service", checked)
    for name in TEXELS:
        monkeypatch.setattr(wq.wq_window_fb, name, 0)
    before = TX.texel.launches
    out = wq.render_wq(scene, cam, 32, 24, 4, max_depth=8, tile_rows=1,
                       window=32, seed=6, return_stats=True, device=CPU)
    assert TX.texel.launches == before
    assert len(calls) == out[2] and {c[0] for c in calls} == set(range(32))
    pending = sum(c[1] for c in calls)
    assert wq.wq_window_fb.texel_pending == pending > 0
    assert wq.wq_window_fb.texel_stalled == pending - sum(c[2]
                                                          for c in calls)


def test_kernel_refuses_cpu_tensors():
    fx = WB.zero_fix(2, CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TX.texel(fx, 0, torch.zeros(1, dtype=torch.int32), 1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the texel kernel has no CPU mode")
    dev = torch.device("cuda")
    return dict(dev=dev, textured=P.TEXTURED_MOTION.build(dev),
                final=P.build_final_scene(200 / 120, device=dev),
                pool=torch.cuda.graph_pool_handle())


def _bits(t):
    t = t.detach()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _equal(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _held(fx, k, atlas_flat, n_atlas):
    """The kernel on (fx, k) held bit-equal to the plain service on the
    same inputs, its counts to `count_nonzero`'s; returns (pending,
    served)."""
    dev = fx.kind.device
    start = torch.tensor([5, 7], dtype=torch.int64, device=dev)
    want = wq.texel_plain(fx, k, atlas_flat, n_atlas, start.clone())
    counts = start.clone()
    before = TX.texel.launches
    got = TX.texel(fx, k, atlas_flat, n_atlas, counts)
    assert TX.texel.launches - before == 2
    assert _equal(want[0], got[0]) and _equal(want[1], got[1]), k
    assert counts.tolist() == want[2].tolist()
    return tuple((counts - start).tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGES)
def test_kernel_is_bit_equal_to_the_plain_service_on_edge_states(card,
                                                                 case):
    kind, idx, ks = probe.texel_edge(case)
    atlas = _atlas(np.random.RandomState(99))
    fx = _fix(kind, idx, card["dev"])
    flat = torch.from_numpy(atlas).to(card["dev"])
    for k in ks:
        pending, served = _held(fx, k, flat, N_ATLAS)
        assert (pending, served) == _rule(kind, idx, k, atlas)[2:]
        texel, srv = TX.texel(fx, k, flat, N_ATLAS)       # no counts
        assert _equal(texel.cpu(), torch.from_numpy(
            _rule(kind, idx, k, atlas)[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("scene,w,h,spp", [("textured", 160, 120, 4),
                                           ("final", 200, 120, 4)])
def test_kernel_is_bit_equal_on_every_bounce_of_real_windows(
        card, monkeypatch, scene, w, h, spp):
    """The eager windowed driver on the card, each bounce's service held
    bit-equal: every k of its 32-bounce windows, served and stalled lanes,
    heavy rows."""
    seen = dict(ks=set(), pending=0, stalled=0, heavy=0)
    real = wq.texel_lanes

    def both(fx, k, atlas_flat, n_atlas, counts=None):
        pending, served = _held(fx, k, atlas_flat, n_atlas)
        seen["ks"].add(k)
        seen["pending"] += pending
        seen["stalled"] += pending - served
        seen["heavy"] += int(((fx.kind != 0).sum(1) > wq.S_SLOTS).sum())
        return real(fx, k, atlas_flat, n_atlas, counts)

    monkeypatch.setattr(wq, "_replays", lambda dev: False)
    monkeypatch.setattr(wq, "texel_lanes", both)
    sc, cam = card[scene]
    out = wq.render_wq(sc, cam, w, h, spp, seed=2 ** 31 + 9,
                       return_stats=True, device=card["dev"])
    torch.cuda.synchronize()
    assert seen["ks"] == set(range(wq.DEF_WINDOW)) and out[2] > 0
    assert seen["pending"] > seen["stalled"] > 0 and seen["heavy"] > 0


@pytest.mark.cuda
def test_replayed_window_gives_its_eager_bodys_bits_and_launches(card):
    dev, (scene, cam) = card["dev"], card["textured"]
    w, h = 160, 120
    n = w * h
    c = wq.window_call(scene, cam, w, h, n_pix_loc=n, chunk=2, cpp=1,
                       n_chunks=n, vcpp=1, pix_base=0, samp_base=0,
                       window=wq.DEF_WINDOW, max_depth=50, attenuate=False,
                       t_min=1e-3, tile_rows=wq.DEF_TILE_ROWS, seed=3,
                       device=dev)
    rows = wq._round_up(n, wq.DEF_TILE_ROWS * wq.LANE) // wq.LANE
    plan = wq.WindowPlan(c)
    cy, _ = wq.window_body(plan.call, wq.zero_carry(rows, n, dev), True)
    before = TX.texel.launches
    g = wq.WindowGraph(plan.call, wq._clone(cy), True, card["pool"])
    assert TX.texel.launches == before          # capturing runs nothing
    assert g.texels == 2 * wq.DEF_WINDOW
    g.replay()
    assert TX.texel.launches - before == 2 * wq.DEF_WINDOW
    want, read = wq.window_body(plan.call, wq._clone(cy), True)
    torch.cuda.synchronize()
    # the counts bit for bit; K1's phase spans are cycles, not bits
    k = len(WB.PHASES)
    assert g.read.tolist()[:-k] == read.tolist()[:-k]
    assert read[3] >= read[4] > 0
    assert all(_equal(a, b) for a, b in zip(wq._leaves(g.carry),
                                            wq._leaves(want)))


@pytest.mark.cuda
@pytest.mark.parametrize("scene,w,h,spp", [("textured", 160, 120, 4),
                                           ("final", 200, 120, 4)])
def test_render_through_graphs_equals_the_plain_service_render(
        card, monkeypatch, scene, w, h, spp):
    """Through graphs, with the kernel and with the plain service in its
    place: image, statistics and texel counters equal; the kernel's
    launches are two a bounce, replays counted."""
    sc, cam = card[scene]
    runs = {}
    for name in ("kernel", "plain"):
        if name == "plain":
            monkeypatch.setattr(wq, "texel_lanes", wq.texel_plain)
        monkeypatch.setattr(wq, "_plans", OrderedDict())
        out = []
        for seed in (3, 3, 2 ** 32 - 5):
            for k in TEXELS:
                monkeypatch.setattr(wq.wq_window_fb, k, 0)
            before = TX.texel.launches
            img, *stats = wq.render_wq(sc, cam, w, h, spp, seed=seed,
                                       return_stats=True, device=card["dev"])
            torch.cuda.synchronize()
            launches = TX.texel.launches - before
            assert launches == (2 * stats[1] if name == "kernel" else 0)
            out.append([img.cpu().numpy().tobytes(), *stats,
                        *(getattr(wq.wq_window_fb, k) for k in TEXELS)])
        runs[name] = out
    assert runs["kernel"] == runs["plain"]
    assert runs["kernel"][0] == runs["kernel"][1] != runs["kernel"][2]
    assert runs["kernel"][0][-2] > runs["kernel"][0][-1] > 0
