"""K1's phase spans (`WaveArgs.spans`, `ops.wave_bounce.PHASES`): the
clock64() cycles of the sphere fold, the rect fold, the triangle fold,
merge and media, and the rest, which the windowed driver zeroes at each
window's start, carries out in the window's one host read and adds to
`wave_bounce.phase_cycles`.  The port alone (no JAX, so the card's tests
run here too).

On the CPU: the plain version counts nothing and a CPU window's read has
no spans; the ctypes mirror and the phase order follow the kernel's
source.

On the card (marked `cuda`, skipped without a GPU): every phase counts in
a `render_wq` of `next_week_final` at 800x800x1, and its rect fold takes
a larger share than `final_scene`'s; a captured window's replay adds the
spans its eager body adds, within 10% (cycles, not bits); a null buffer
leaves the image bit-equal and counts nothing; and the SASS of every
innermost loop of K1, the folds among them, is the same with the spans
compiled in as with them compiled out (`-DK1_SPANS=0`, the parent's
code).
"""
import os
import re
import subprocess
from collections import OrderedDict

import pytest
import torch

from path_tracer_tpu_torch.engine import wq
from path_tracer_tpu_torch.ops import build
from path_tracer_tpu_torch.ops import wave_bounce as WB
from path_tracer_tpu_torch.scene import presets as P

CPU = torch.device("cpu")
SRC = build.SRC_DIR / "wave_bounce.cu"


def _cycles():
    return list(WB.wave_bounce.phase_cycles)


def _added(before):
    return [a - b for a, b in zip(WB.wave_bounce.phase_cycles, before)]


def test_the_plain_version_counts_nothing():
    scene, cam = P.CORNELL_BOX.build(CPU)
    before = _cycles()
    img, segs, _, _ = wq.render_wq(scene, cam, 16, 16, 2, max_depth=6,
                                   tile_rows=1, window=3, seed=2,
                                   return_stats=True, device=CPU)
    assert segs > 0 and _cycles() == before
    c = wq.window_call(scene, cam, 16, 16, n_pix_loc=256, chunk=2, cpp=1,
                       n_chunks=256, vcpp=1, pix_base=0, samp_base=0,
                       window=3, max_depth=6, attenuate=False, t_min=1e-3,
                       tile_rows=1, seed=2, device=CPU)
    cy = wq.zero_carry(2, 256, CPU)
    _, read = wq.window_body(c, cy, True)
    assert read.shape == (wq.read_size(c, True),) == (3,)


def test_the_mirror_and_the_phases_follow_the_source():
    src = SRC.read_text()
    struct = re.search(r"struct WaveArgs \{(.*?)\n\};", src, re.S).group(1)
    last = re.findall(r"(\w+);", re.sub(r"//.*", "", struct))[-1]
    assert last == WB._Args._fields_[-1][0] == "spans"
    enum = re.search(r"enum \{ (PH_\w+(?:, PH_\w+)*), N_PHASES \}",
                     src).group(1)
    assert [p[3:].lower() for p in enum.split(", ")] == \
        ["sphere", "rect", "tri", "media", "rest"] == list(WB.PHASES)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1's spans are clock64() reads "
                    "of the CUDA kernel, which has no CPU mode")
    dev = torch.device("cuda")
    return dict(dev=dev, nwf=P.NEXT_WEEK_FINAL.build(dev),
                pool=torch.cuda.graph_pool_handle())


def _render(scene, cam, w, h, spp, depth, seed=7):
    before = _cycles()
    img, segs, _, _ = wq.render_wq(scene, cam, w, h, spp, max_depth=depth,
                                   seed=seed, return_stats=True,
                                   device=scene.spheres.radius.device)
    torch.cuda.synchronize()
    return img.cpu().numpy(), segs, _added(before)


@pytest.fixture(scope="module")
def shares(card):
    dev = card["dev"]
    out = {}
    _, _, nwf = _render(*card["nwf"], 800, 800, 1, 40)
    out["next_week_final"] = nwf
    scene, cam = P.build_final_scene(800 / 480, device=dev)
    _, _, fs = _render(scene, cam, 800, 480, 1, 50)
    out["final_scene"] = fs
    return out


@pytest.mark.cuda
def test_every_phase_counts_in_next_week_final(shares):
    cyc = shares["next_week_final"]
    assert all(c > 0 for c in cyc), dict(zip(WB.PHASES, cyc))


@pytest.mark.cuda
def test_the_rect_share_is_higher_than_in_final_scene(shares):
    rect = {k: v[1] / sum(v) for k, v in shares.items()}
    assert rect["next_week_final"] > rect["final_scene"], rect


@pytest.mark.cuda
def test_replay_adds_the_spans_of_its_eager_body(card):
    dev, (scene, cam) = card["dev"], card["nwf"]
    w, h = 400, 400
    n = w * h
    c = wq.window_call(scene, cam, w, h, n_pix_loc=n, chunk=1, cpp=1,
                       n_chunks=n, vcpp=1, pix_base=0, samp_base=0,
                       window=wq.DEF_WINDOW, max_depth=40, attenuate=False,
                       t_min=1e-3, tile_rows=wq.DEF_TILE_ROWS, seed=3,
                       device=dev)
    rows = wq._round_up(n, wq.DEF_TILE_ROWS * wq.LANE) // wq.LANE
    plan = wq.WindowPlan(c)
    cy, _ = wq.window_body(plan.call, wq.zero_carry(rows, n, dev), True)
    g = wq.WindowGraph(plan.call, wq._clone(cy), True, card["pool"])
    g.replay()
    want, read = wq.window_body(plan.call, wq._clone(cy), True)
    torch.cuda.synchronize()
    k = len(WB.PHASES)
    got, read = g.read.tolist(), read.tolist()
    assert len(read) == wq.read_size(c, True)
    assert got[:-k] == read[:-k]
    for p, a, b in zip(WB.PHASES, got[-k:], read[-k:]):
        assert b > 0 and abs(a - b) <= 0.1 * b, (p, a, b)


@pytest.mark.cuda
def test_a_null_buffer_keeps_the_image_and_counts_nothing(card,
                                                          monkeypatch):
    scene, cam = card["nwf"]
    img, segs, cyc = _render(scene, cam, 200, 200, 2, 40, seed=11)
    assert sum(cyc) > 0
    monkeypatch.setattr(wq, "_plans", OrderedDict())
    monkeypatch.setattr(wq, "_spans", lambda c: False)
    img0, segs0, cyc0 = _render(scene, cam, 200, 200, 2, 40, seed=11)
    assert cyc0 == [0] * len(WB.PHASES)
    assert segs0 == segs and img0.tobytes() == img.tobytes()


def _sass(tmp_path, name, *defines):
    cubin = tmp_path / f"{name}.cubin"
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([build.nvcc(), *flags, *defines, "-cubin", "-o",
                    str(cubin), str(SRC)], check=True, capture_output=True)
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout


def innermost_loops(sass: str) -> dict:
    """Each K1 function's innermost loops (a backward branch's target up to
    the branch, holding no other backward branch), as their instructions
    with addresses dropped and branch targets (a label, or an address)
    made relative to the loop's start."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m and name:
            funcs[name].append(("label", m.group(1), None))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*?)\s*;", line)
        if m and name:
            funcs[name].append(("ins", m.group(2), int(m.group(1), 16)))
    target = re.compile(r"(BRA\b[^`;]*?)(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))")
    out = {}
    for fn, items in funcs.items():
        if "wave_kernel" not in fn:
            continue
        at = {v: i for i, (k, v, _) in enumerate(items) if k == "label"}
        at.update({a: i for i, (k, _, a) in enumerate(items) if k == "ins"})

        def dest(text):
            m = target.search(text)
            if m is None:
                return None
            return at.get(m.group(2) or int(m.group(3), 16))

        back = [(dest(v), i) for i, (k, v, _) in enumerate(items)
                if k == "ins" and dest(v) is not None and dest(v) < i]
        loops = []
        for lo, hi in back:
            if any(lo <= a and b < hi and (a, b) != (lo, hi)
                   for a, b in back):
                continue
            body = []
            for k, v, _ in items[lo:hi + 1]:
                if k == "ins":
                    d = dest(v)
                    v = target.sub(lambda m: m.group(1) + "@", v)
                    v += "" if d is None else f" ->{d - lo}"
                body.append(v if k == "ins" else "label")
            loops.append(tuple(body))
        out[fn] = loops
    return out


@pytest.mark.cuda
def test_the_fold_loops_sass_is_unchanged(card, tmp_path):
    on = innermost_loops(_sass(tmp_path, "on"))
    off = innermost_loops(_sass(tmp_path, "off", "-DK1_SPANS=0"))
    assert set(on) == set(off) and len(on) >= 24
    assert all(off[f] for f in off)
    for f in off:
        assert on[f] == off[f], f
