"""The windowed driver's texel-service counters, `wq_window_fb.texel_pending`
and `.texel_stalled`, with the port alone (no JAX, so the card's test
runs here too).

On the CPU: on a textured scene the counters equal a recount of every
texel-service call of the eager driver (pending fixups, and those left
uncovered); the card's plan path, with the capture stood in by an eager
replay, counts the same; on the Cornell box (no image texture) they stay
zero and a window dispatches exactly the ops of the body before the
counters; every window takes one host read.  (The images keep the bits
`test_torch_wq_graph.py` pins, which its own tests hold.)

On the card (marked `cuda`, skipped without a GPU): a captured window's
replay reads the same counters as its eager body, and `render_wq`
through graphs counts what the eager driver counts.
"""
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from path_tracer_tpu_torch.engine import wq
from path_tracer_tpu_torch.ops import wave_bounce as WB
from path_tracer_tpu_torch.scene import presets as P

from test_torch_wq_graph import _summary, stand_in  # noqa: F401

CPU = torch.device("cpu")
TEXELS = ("texel_pending", "texel_stalled")


def _texels():
    return tuple(getattr(wq.wq_window_fb, k) for k in TEXELS)


@pytest.fixture(scope="module")
def scenes():
    return {"cornell": P.CORNELL_BOX.build(CPU),
            "textured": P.TEXTURED_MOTION.build(CPU)}


@pytest.fixture
def zeroed(monkeypatch):
    for k in TEXELS:
        monkeypatch.setattr(wq.wq_window_fb, k, 0)


def _render(scenes, name, w=32, h=24, seed=5):
    sc, cam = scenes[name]
    return wq.render_wq(sc, cam, w, h, 2, max_depth=8, tile_rows=1,
                        window=3, seed=seed, return_stats=True, device=CPU)


def _recount(monkeypatch):
    """Every texel-service call's (pending, uncovered) lanes, from its
    inputs and outputs."""
    calls = []
    real = wq.texel_service

    def counted(fx, k, atlas_flat, n_atlas):
        texel, srv = real(fx, k, atlas_flat, n_atlas)
        need = fx.kind != 0.0
        calls.append((int(need.sum()), int((need & (srv <= 0.0)).sum())))
        return texel, srv

    monkeypatch.setattr(wq, "texel_service", counted)
    return calls


def test_counters_equal_a_recount_of_the_eager_driver(scenes, zeroed,
                                                      monkeypatch):
    calls = _recount(monkeypatch)
    out = _render(scenes, "textured")
    assert len(calls) == out[2]            # one service call a bounce
    pending = sum(p for p, _ in calls)
    stalled = sum(s for _, s in calls)
    assert _texels() == (pending, stalled)
    assert pending > 0 and 0 <= stalled <= pending


def test_a_shard_counts_its_windows_too(scenes, zeroed, monkeypatch):
    calls = _recount(monkeypatch)
    sc, cam = scenes["textured"]
    wq.wq_window_fb(sc, cam, 32, 24, n_pix_loc=300, spp_loc=4, chunk=2,
                    window=3, max_depth=8, attenuate=False, t_min=1e-3,
                    tile_rows=1, seed=11, device=CPU, pix_base=200,
                    samp_base=4, valid_pix=250, valid_cpp=1)
    assert _texels() == (sum(p for p, _ in calls), sum(s for _, s in calls))
    assert _texels()[0] > 0


def test_eager_captured_and_replayed_windows_count_alike(scenes, zeroed,
                                                         stand_in,
                                                         monkeypatch):
    """The first call of a shape runs each kind eagerly once and captures
    it on its second window; the second call replays every window."""
    monkeypatch.setattr(wq, "_replays", lambda dev: False)
    eager = _render(scenes, "textured")
    want = _texels()
    assert want[0] > 0
    monkeypatch.setattr(wq, "_replays", lambda dev: True)
    first = _render(scenes, "textured")
    assert _texels() == tuple(2 * n for n in want)
    assert wq.wq_window_fb.captures > 0
    replays = wq.wq_window_fb.replays
    second = _render(scenes, "textured")
    assert _texels() == tuple(3 * n for n in want)
    assert wq.wq_window_fb.replays - replays == second[2] // 3
    assert _summary(first) == _summary(second) == _summary(eager)


def test_cornell_box_counts_nothing(scenes, zeroed, stand_in):
    for _ in range(3):
        _render(scenes, "cornell")
    assert wq.wq_window_fb.replays > 0
    assert _texels() == (0, 0)


class Ops(TorchDispatchMode):
    """The ATen ops dispatched while it is open, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _body_before_counters(c, cy, refill):
    """`window_body` as it was before the texel counters (with the refill's
    no-op count, which every refill window reads)."""
    st, ex, fx, fb, counter = cy
    noop = torch.zeros((), dtype=torch.int64) if refill else None
    for k in range(c.window):
        if refill:
            st, ex, counter, noop = wq.refill_lanes(c, st, ex, counter, fx,
                                                    noop)
        texel, srv = wq.texel_service(fx, k, c.atlas_flat, c.n_atlas)
        out = WB.wave_bounce(c.tables, st, fix=fx, texel=texel, srv=srv,
                             t_min=c.t_min, max_depth=c.max_depth,
                             attenuate=c.attenuate, tile_rows=c.tile_rows)
        st, fx = out.state, out.fix
    if ex is not None:
        ex, fb = wq.deposit(ex, fb, c.n_pix_loc, c.cpp, c.pix_base)
    return (wq.Carry(st, ex, fx, fb, counter),
            torch.stack([counter, wq._nlive(st, fx)]
                        + ([noop] if refill else [])))


def _call(scenes, name, w=32, h=24):
    sc, cam = scenes[name]
    n = w * h
    return wq.window_call(sc, cam, w, h, n_pix_loc=n, chunk=2, cpp=1,
                          n_chunks=n, vcpp=1, pix_base=0, samp_base=0,
                          window=3, max_depth=8, attenuate=False, t_min=1e-3,
                          tile_rows=1, seed=5, device=CPU)


@pytest.mark.parametrize("refill", [True, False])
def test_a_window_without_image_textures_adds_no_op(scenes, refill):
    c = _call(scenes, "cornell")
    assert not wq._textured(c)
    cy = wq.zero_carry(8, 32 * 24, CPU)
    if not refill:
        cy = cy._replace(ex=None, fb=None)
    runs = []
    for body in (wq.window_body, _body_before_counters):
        with Ops() as ops:
            out, read = body(c, wq._clone(cy), refill)
        runs.append((ops.names, read.tolist(),
                     [t.numpy().tobytes() for t in wq._leaves(out)]))
    assert runs[0] == runs[1]
    assert len(runs[0][1]) == 2 + refill


def test_a_textured_window_reads_four_numbers(scenes):
    c = _call(scenes, "textured")
    assert wq._textured(c)
    cy = wq.zero_carry(8, 32 * 24, CPU)
    out, read = wq.window_body(c, cy, True)
    want, want_read = _body_before_counters(c, cy, True)
    # [granted, live, no-op refills, pending, served]
    assert read.shape == (5,) and read[:3].tolist() == want_read.tolist()
    assert [t.numpy().tobytes() for t in wq._leaves(out)] == \
        [t.numpy().tobytes() for t in wq._leaves(want)]
    pending, served = read[3:].tolist()
    assert 0 <= served <= pending


@pytest.mark.parametrize("plan", [False, True])
def test_one_host_read_a_window(scenes, zeroed, stand_in, monkeypatch, plan):
    """The windowed driver's `tolist` is the window's read (the drain stages'
    boundaries read the host on their own, as before)."""
    if not plan:
        monkeypatch.setattr(wq, "_replays", lambda dev: False)
    reads = []
    real = torch.Tensor.tolist

    def counted(self):
        if sys._getframe(1).f_code.co_filename == wq.__file__:
            reads.append(self.shape)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    for _ in range(2):
        reads.clear()
        out = _render(scenes, "textured")
        assert len(reads) == out[2] // 3
        # refill windows read the no-op count too
        assert set(reads) == {torch.Size([5]), torch.Size([4])}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and K1 have no CPU "
                    "mode")
    dev = torch.device("cuda")
    return dict(dev=dev, scene=P.TEXTURED_MOTION.build(dev),
                pool=torch.cuda.graph_pool_handle())


@pytest.mark.cuda
def test_replayed_window_counts_what_its_eager_body_counts(card,
                                                           monkeypatch):
    dev, (scene, cam) = card["dev"], card["scene"]
    w, h = 160, 120
    n = w * h
    c = wq.window_call(scene, cam, w, h, n_pix_loc=n, chunk=2, cpp=1,
                       n_chunks=n, vcpp=1, pix_base=0, samp_base=0,
                       window=wq.DEF_WINDOW, max_depth=50, attenuate=False,
                       t_min=1e-3, tile_rows=wq.DEF_TILE_ROWS, seed=3,
                       device=dev)
    rows = wq._round_up(n, wq.DEF_TILE_ROWS * wq.LANE) // wq.LANE
    cy0 = wq.zero_carry(rows, n, dev)
    plan = wq.WindowPlan(c)
    # two windows in: fixups are pending
    cy, _ = wq.window_body(plan.call, wq._clone(cy0), True)
    cy, _ = wq.window_body(plan.call, cy, True)
    g = wq.WindowGraph(plan.call, wq._clone(cy), True, card["pool"])
    g.replay()
    want, read = wq.window_body(plan.call, wq._clone(cy), True)
    torch.cuda.synchronize()
    # the counts bit for bit; K1's phase spans are cycles, not bits
    k = len(WB.PHASES)
    assert g.read.tolist()[:-k] == read.tolist()[:-k]
    assert read.shape == (5 + k,)
    assert read[3] > 0
    # render_wq through graphs against the eager windowed driver
    render = lambda: wq.render_wq(scene, cam, w, h, 2, seed=4,
                                  return_stats=True, device=dev)
    counts = []
    for replays in (False, True, True, True):
        monkeypatch.setattr(wq, "_replays", lambda d, r=replays: r)
        for k in TEXELS:
            monkeypatch.setattr(wq.wq_window_fb, k, 0)
        out = render()
        torch.cuda.synchronize()
        counts.append((_texels(), out[0].cpu().numpy().tobytes(), out[1:]))
    assert counts[0][0][0] > 0
    assert all(x == counts[0] for x in counts[1:])
