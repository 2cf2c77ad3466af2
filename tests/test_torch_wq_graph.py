"""The windowed driver's windows as CUDA graphs (`engine.wq.WindowPlan`),
with the port alone (no JAX, so the card's tests run here too).

On the CPU the driver runs `window_body` eagerly and the graph counters
do not move.  Its outputs for the Cornell box, a textured preset, a
sample range, a ragged shard, the one-bounce driver and the queued
gradient route are also pinned bit for bit (sha256 of the bytes) to what
the driver gave before its windows could be replayed: a one-off guard for
that change, which a later change may drop (float bits on the CPU can
move with the torch build).  The divisor constants `core.vec.fdiv`
caches give the bits of a fresh 0-d divisor.  With the capture stood in
by an eager run of the same body, the plan's bookkeeping (static
carries, inputs loaded per call, a kind of window run eagerly the first
time and captured the second, replays after, one plan for every camera
and seed) gives the eager driver's bits, compared live.

On the card (marked `cuda`, skipped without a GPU): a captured window's
replay is bit-equal to its eager body on the same static inputs, for
three seeds, a changed material colour, a moved camera and a 704-row
drain window; `render_wq` and `render_wq_range` through graphs are
bit-equal to the eager driver, count the same K1 launches and lanes, a
shape's first call runs every window eagerly, and its third call
captures nothing and replays every window, for a moved camera too.
"""
import hashlib
from collections import OrderedDict
from contextlib import nullcontext

import pytest
import torch

from path_tracer_tpu_torch.core import vec
from path_tracer_tpu_torch.diff import params as TP
from path_tracer_tpu_torch.diff import queued_vjp as TQ
from path_tracer_tpu_torch.engine import wq
from path_tracer_tpu_torch.ops import wave_bounce as WB
from path_tracer_tpu_torch.scene import presets as P

CPU = torch.device("cpu")
COUNTERS = ("captures", "replays", "eager_windows")


def _digest(t: torch.Tensor) -> str:
    data = t.detach().cpu().contiguous().numpy().tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def _counters():
    return {k: getattr(wq.wq_window_fb, k) for k in COUNTERS}


@pytest.fixture(scope="module")
def scenes():
    return {"cornell": P.CORNELL_BOX.build(CPU),
            "textured": P.TEXTURED_MOTION.build(CPU)}


def _cornell(s):
    sc, cam = s["cornell"]
    return wq.render_wq(sc, cam, 32, 32, 2, max_depth=8, tile_rows=1,
                        window=3, seed=7, return_stats=True, device=CPU)


def _textured(s):
    sc, cam = s["textured"]
    return wq.render_wq(sc, cam, 32, 24, 2, max_depth=8, tile_rows=1,
                        window=3, seed=5, return_stats=True, device=CPU)


def _range(s):
    sc, cam = s["cornell"]
    return (wq.render_wq_range(sc, cam, 24, 24, 2, 4, max_depth=8,
                               tile_rows=1, window=3, seed=9, device=CPU),)


def _shard(s):
    sc, cam = s["textured"]
    return wq.wq_window_fb(sc, cam, 32, 24, n_pix_loc=300, spp_loc=4,
                           chunk=2, window=3, max_depth=8, attenuate=False,
                           t_min=1e-3, tile_rows=1, seed=11, device=CPU,
                           pix_base=200, samp_base=4, valid_pix=250,
                           valid_cpp=1)


def _one_bounce(s):
    sc, cam = s["textured"]
    return wq.render_wq(sc, cam, 16, 16, 2, max_depth=8, tile_rows=1,
                        window=1, seed=3, return_stats=True, device=CPU)


def _queued(s):
    scene, cam = P.build_final_scene(16 / 12, device=CPU)
    f = TQ.render_grad_fb(16, 12, 16 * 12, 2, max_depth=4, device=CPU)
    params, static = TP.partition((scene, cam))
    xs = [x.clone().requires_grad_(True) for x in TP.leaves(params)]
    img = f(*TP.combine(TP.with_leaves(params, xs), static))
    gs = torch.autograd.grad(img.mean(), xs, allow_unused=True)
    return img, torch.cat([g.reshape(-1) for g in gs if g is not None])


# (digest of the first output, then the rest as returned): recorded from
# the eager driver before windows could be replayed, a one-off guard
PINNED = {
    "cornell": (_cornell, ["0ff64bdffba788e3", 10023.0, 18, 16128.0]),
    "textured": (_textured, ["65c61c35dd9b87f6", 3011.0, 18, 6144.0]),
    "range": (_range, ["d45d4512c5194f71"]),
    "shard": (_shard, ["9fc2fb07f7e1c64f", 1281.0, 15, 3456.0]),
    "one_bounce": (_one_bounce, ["9efe6c0b60782fd8", 1014.0, 10, 2560.0]),
}


def _summary(out):
    return [_digest(out[0])] + list(out[1:])


@pytest.mark.parametrize("case", sorted(PINNED))
def test_cpu_driver_gives_the_pinned_bits_and_counts_no_window(scenes, case):
    fn, want = PINNED[case]
    before = _counters()
    assert _summary(fn(scenes)) == want
    assert _counters() == before


def test_queued_route_gives_the_pinned_bits(scenes):
    img, grads = _queued(scenes)
    assert [_digest(img), _digest(grads)] == ["53d1f313e0ae1f35",
                                              "8183ce67b88abcb4"]


# the divisors the driver and its callers use: frame sizes, spp, the
# preview's running-mean counts, 2 pi
DIVISORS = [600.0, 480.0, 32.0, 24.0, 12.0, 1.0, 2.0, 100.0, 7.0, 300.0,
            6.2831854820251465]


@pytest.mark.parametrize("d", DIVISORS)
def test_cached_divisor_gives_the_bits_of_a_fresh_one(d):
    x = torch.rand(4096, generator=torch.Generator().manual_seed(3)) * 1000.0
    want = x / torch.tensor(d)
    got = vec.fdiv(x, d)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert vec.divisor(d, torch.float32, CPU) is vec.divisor(
        d, torch.float32, CPU)


def test_divisor_cache_keys_the_sign_of_zero_and_is_bounded(monkeypatch):
    monkeypatch.setattr(vec, "_divisors", OrderedDict())
    one = torch.ones(1)
    assert float(vec.fdiv(one, 0.0)) == float("inf")
    assert float(vec.fdiv(one, -0.0)) == float("-inf")
    for i in range(vec.DIVISORS + 10):
        vec.divisor(float(i + 1), torch.float32, CPU)
    assert len(vec.live_divisors()) == vec.DIVISORS


class EagerGraph:
    """A stand-in for `WindowGraph` on the CPU: capturing runs nothing,
    and a replay runs the same body on the static carry and copies the
    result back, as the graph's last nodes do."""

    def __init__(self, c, static, refill, pool):
        self.c, self.carry, self.refill = c, static, refill
        self.read = torch.zeros(wq.read_size(c, refill), dtype=torch.int64)

    def replay(self):
        out, read = wq.window_body(self.c, self.carry, self.refill)
        wq._copy_into(self.carry, out)
        self.read.copy_(read)


def _eager(monkeypatch, fn, *args):
    """fn(*args) on the eager driver, with no plan."""
    monkeypatch.setattr(wq, "_replays", lambda dev: False)
    try:
        return fn(*args)
    finally:
        monkeypatch.setattr(wq, "_replays", lambda dev: True)


def _same(a, b):
    return _summary(a) == _summary(b)


@pytest.fixture
def stand_in(monkeypatch):
    """The card's plan path on the CPU, each test with no plan cached."""
    monkeypatch.setattr(wq, "_plans", OrderedDict())
    monkeypatch.setattr(wq, "_pools", {})
    monkeypatch.setattr(wq, "WindowGraph", EagerGraph)
    monkeypatch.setattr(wq, "_replays", lambda dev: True)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    for k in COUNTERS:
        monkeypatch.setattr(wq.wq_window_fb, k, 0)


def _windows(out, window=3):
    return out[2] // window


@pytest.mark.parametrize("case", ["cornell", "textured"])
def test_plan_captures_each_kind_once_then_replays(scenes, stand_in,
                                                   monkeypatch, case):
    """A kind of window runs eagerly the first time, is captured the
    second, and replays after; every call gives the eager driver's bits."""
    fn, want = PINNED[case]
    eager = _eager(monkeypatch, fn, scenes)
    assert _counters() == dict(captures=0, replays=0, eager_windows=0)
    first = fn(scenes)
    assert _same(first, eager) and _summary(first) == want
    plan = wq._plans[next(iter(wq._plans))]
    kinds = len(plan.seen)
    assert kinds >= 2                 # a refill window and a drain window
    n = _windows(first)
    assert _counters() == dict(captures=len(plan.graphs),
                               replays=n - kinds, eager_windows=kinds)
    second = fn(scenes)
    assert _same(second, eager)
    assert _counters() == dict(captures=kinds, replays=2 * n - kinds,
                               eager_windows=kinds)
    assert _same(fn(scenes), eager)
    assert _counters() == dict(captures=kinds, replays=3 * n - kinds,
                               eager_windows=kinds)
    assert len(wq._plans) == 1


def test_a_shape_seen_once_runs_every_window_eagerly(scenes, stand_in):
    """A call whose kinds of window each come once captures nothing: it
    costs what the eager driver costs."""
    sc, cam = scenes["cornell"]
    out = wq.render_wq(sc, cam, 16, 16, 1, max_depth=8, tile_rows=1,
                       window=32, seed=2, return_stats=True, device=CPU)
    n = _windows(out, 32)
    assert _counters() == dict(captures=0, replays=0, eager_windows=n)
    assert len(wq._plans[next(iter(wq._plans))].seen) == n


def test_plan_loads_each_calls_inputs(scenes, stand_in, monkeypatch):
    """Another seed, a moved sample base, a ragged shard and a moved
    camera reuse the plan of their shape and give the eager driver's
    bits."""
    sc, cam = scenes["cornell"]
    moved = cam._replace(origin=cam.origin._replace(x=cam.origin.x + 10.0),
                         lens_radius=cam.lens_radius + 0.5)
    kw = dict(max_depth=8, tile_rows=1, window=3, device=CPU)
    calls = [lambda: wq.render_wq(sc, cam, 32, 32, 2, seed=8, **kw),
             lambda: wq.render_wq_range(sc, cam, 32, 32, 4, 2, seed=7, **kw),
             lambda: wq.render_wq_range(sc, cam, 32, 32, 6, 2, seed=7, **kw),
             lambda: wq.render_wq(sc, moved, 32, 32, 2, seed=7, **kw)]
    wq.render_wq(sc, cam, 32, 32, 2, seed=7, **kw)
    wq.render_wq(sc, cam, 32, 32, 2, seed=7, **kw)
    captures = wq.wq_window_fb.captures
    graphed = [f() for f in calls]
    assert wq.wq_window_fb.captures == captures == len(
        wq._plans[next(iter(wq._plans))].graphs)
    assert len(wq._plans) == 1
    eager = [_eager(monkeypatch, f) for f in calls]
    assert _digest(eager[3]) != _digest(eager[0])    # the camera moved
    for g, e in zip(graphed, eager):
        assert _digest(g) == _digest(e)


def test_shard_through_the_plan_gives_the_pinned_bits(scenes, stand_in,
                                                      monkeypatch):
    fn, want = PINNED["shard"]
    eager = _eager(monkeypatch, fn, scenes)
    for _ in range(3):
        out = fn(scenes)
        assert _same(out, eager) and _summary(out) == want
    assert wq.wq_window_fb.replays > 0


def test_plans_are_kept_least_recently_used(scenes, stand_in):
    sc, cam = scenes["cornell"]
    for w in range(8, 8 + wq.GRAPH_PLANS + 2):
        wq.render_wq(sc, cam, w, 8, 1, max_depth=2, tile_rows=1, window=3,
                     device=CPU)
    assert len(wq._plans) == wq.GRAPH_PLANS
    assert [k[1] for k in wq._plans] == list(
        range(10, 8 + wq.GRAPH_PLANS + 2))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

W_BOX, H_BOX = 600, 600
ROWS_BOX = 2816          # 360,000 pixels in 64-row tiles of 128 lanes
DRAIN_ROWS = 704         # the first drain stage: 11 of its 44 tiles


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and K1 have no CPU "
                    "mode")
    dev = torch.device("cuda")
    scene, cam = P.CORNELL_BOX.build(dev)
    return dict(dev=dev, scene=scene, cam=cam,
                pool=torch.cuda.graph_pool_handle())


def _box_call(card, seed=1, scene=None, cam=None):
    n = W_BOX * H_BOX
    return wq.window_call(
        scene if scene is not None else card["scene"],
        cam if cam is not None else card["cam"], W_BOX, H_BOX,
        n_pix_loc=n, chunk=1, cpp=1, n_chunks=n, vcpp=1, pix_base=0,
        samp_base=0, window=wq.DEF_WINDOW, max_depth=50, attenuate=False,
        t_min=1e-3, tile_rows=wq.DEF_TILE_ROWS, seed=seed,
        device=card["dev"])


def _bytes(tree):
    return [t.cpu().numpy().tobytes() for t in wq._leaves(tree)]


def _graph(card, c, cy0, refill):
    """A plan for `c` with one window captured on a static copy of cy0,
    after an eager run of the body (as the driver warms each kind)."""
    plan = wq.WindowPlan(c)
    wq.window_body(plan.call, wq._clone(cy0), refill)
    static = wq._clone(cy0)
    return plan, wq.WindowGraph(plan.call, static, refill, card["pool"])


def _replay_matches_eager(plan, g, c, cy0, refill):
    plan.load(c)
    wq._copy_into(g.carry, cy0)
    g.replay()
    want, read = wq.window_body(c, wq._clone(cy0), refill)
    torch.cuda.synchronize()
    assert _bytes(g.carry) == _bytes(want)
    # the counts bit for bit; K1's phase spans are cycles, not bits
    k = len(WB.PHASES)
    assert g.read.tolist()[:-k] == read.tolist()[:-k]
    return want


def _colour_changed(scene):
    """Every solid albedo's red scaled: the same shapes, other tables."""
    tx = scene.textures
    return scene._replace(textures=tx._replace(
        c1=tx.c1._replace(x=tx.c1.x * 0.9)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["seed1", "seed2", "seed3", "colour",
                                  "camera", "drain704"])
def test_window_replay_is_bit_equal_to_its_eager_body(card, case):
    dev = card["dev"]
    cy0 = wq.zero_carry(ROWS_BOX, W_BOX * H_BOX, dev)
    c1 = _box_call(card, seed=1)
    refill = True
    if case == "drain704":
        out, _ = wq.window_body(c1, wq._clone(cy0), True)
        st, fx = wq.compact(out.st, out.fx, DRAIN_ROWS)[:2]
        cy0 = wq.Carry(st, None, fx, None, out.counter)
        refill = False
    plan, g = _graph(card, c1, cy0, refill)
    if case.startswith("seed"):
        c = _box_call(card, seed=int(case[-1]))
    elif case == "colour":
        c = _box_call(card, scene=_colour_changed(card["scene"]))
    elif case == "camera":          # read from the packed table
        cam = card["cam"]
        c = _box_call(card, cam=cam._replace(origin=cam.origin._replace(
            x=cam.origin.x + 10.0)))
    else:
        c = c1
    out = _replay_matches_eager(plan, g, c, cy0, refill)
    assert len(g.lanes) == wq.DEF_WINDOW
    assert set(g.lanes) == {cy0.st.ox.numel()}
    if case == "seed2":          # the seed word moved the streams
        c_1 = _replay_matches_eager(plan, g, c1, cy0, refill)
        assert _bytes(c_1.st.rng) != _bytes(out.st.rng)


def _counted(fn):
    """fn()'s result, K1's launches and the lanes the events hold."""
    events = []
    WB.wave_bounce.events = events
    before = WB.wave_bounce.launches
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        WB.wave_bounce.events = None
    return out, WB.wave_bounce.launches - before, sum(n for n, _, _ in events)


@pytest.mark.cuda
@pytest.mark.parametrize("preset,w,h", [("cornell_box", 200, 200),
                                        ("textured_motion", 160, 120)])
def test_render_through_graphs_is_bit_equal_to_eager(card, monkeypatch,
                                                     preset, w, h):
    """A shape's first call runs each kind of window eagerly once, its
    second has captured every kind, its third captures nothing and
    replays every window, and a moved camera and a new seed reuse the
    graphs; every call gives the eager driver's bits, launches and
    lanes."""
    dev = card["dev"]
    scene, cam = P.PRESETS[preset].build(dev)
    moved = cam._replace(origin=cam.origin._replace(x=cam.origin.x + 1.0))
    render = lambda seed, c=cam: wq.render_wq(scene, c, w, h, 2, seed=seed,
                                              return_stats=True, device=dev)
    ranged = lambda base: wq.render_wq_range(scene, cam, w, h, base, 2,
                                             seed=4, device=dev)
    monkeypatch.setattr(wq, "_replays", lambda d: False)
    eager = [_counted(lambda: render(s)) for s in (3, 4)]
    eager_moved = _counted(lambda: render(3, moved))
    eager_r = [ranged(b) for b in (0, 2)]
    monkeypatch.setattr(wq, "_replays", lambda d: True)
    monkeypatch.setattr(wq, "_plans", OrderedDict())
    c0 = _counters()
    first = _counted(lambda: render(3))
    windows = first[0][2] // wq.DEF_WINDOW
    plan = wq._plans[next(iter(wq._plans))]
    kinds = len(plan.seen)     # a kind's second window of the call captures
    assert _counters() == dict(
        captures=c0["captures"] + len(plan.graphs),
        replays=c0["replays"] + windows - kinds,
        eager_windows=c0["eager_windows"] + kinds)
    second = _counted(lambda: render(3))
    c2 = _counters()
    assert c2["captures"] == c0["captures"] + kinds
    again = _counted(lambda: render(3))
    moved_g = _counted(lambda: render(3, moved))
    moved_windows = moved_g[0][2] // wq.DEF_WINDOW
    assert _counters() == dict(
        captures=c2["captures"],
        replays=c2["replays"] + windows + moved_windows,
        eager_windows=c2["eager_windows"])
    graphed = [first, second, again, _counted(lambda: render(4)), moved_g]
    want = [eager[0], eager[0], eager[0], eager[1], eager_moved]
    for (g, gl, gn), (e, el, en) in zip(graphed, want):
        assert _bytes(g[0]) == _bytes(e[0]) and g[1:] == e[1:]
        assert (gl, gn) == (el, en)
    assert _bytes(eager_moved[0][0]) != _bytes(eager[0][0][0])
    graphed_r = [ranged(b) for b in (0, 2)]
    for g, e in zip(graphed_r, eager_r):
        assert _bytes(g) == _bytes(e)
