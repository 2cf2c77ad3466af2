"""The work queue's shared steps (`engine.wq`), with the port alone (no
JAX): the one stream seed `core.rng.seed_perf`, the K1-input helper
`k1_inputs`, the grant, bank and path-start steps every driver calls, and
the two gradient recorders that call them.

`seed_perf` gives the bits of the stream seed as the drivers wrote it
inline before it was shared, splitmix32(pix ^ splitmix32(s ^ seed)) with
0 mapped to the xorshift start state, for an int seed and for the 0-d
int64 seed word K1 reads, and reads no number back from the device word
(it runs on the meta device, which has none to read).  The zero case is
built from splitmix32's inverse at 0.  `k1_inputs` gives the tables and
the atlas of the recipe it replaces.  The recorders' outputs are pinned
by sha256 to what they gave before the refill was shared, for a
schedule whose stage A ends mid-chunk, so that both the tail's single
samples and stage B's leftover queue are granted.
"""
import hashlib

import pytest
import torch

from path_tracer_tpu_torch.core import rng as R
from path_tracer_tpu_torch.diff import pallas_vjp as PV
from path_tracer_tpu_torch.diff import queued_vjp as TQ
from path_tracer_tpu_torch.engine import wq
from path_tracer_tpu_torch.ops import wave_bounce as WB
from path_tracer_tpu_torch.scene import presets as P

CPU = torch.device("cpu")
PRESETS = {"cornell": P.CORNELL_BOX, "textured": P.TEXTURED_MOTION}


def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.fixture(scope="module")
def scenes():
    return {k: p.build(CPU) for k, p in PRESETS.items()}


# ---------------------------------------------------------------------------
# the stream seed
# ---------------------------------------------------------------------------

def _inline(pix, s, seed):
    """The stream seed as the drivers wrote it before `seed_perf`."""
    h = R.splitmix32(pix ^ R.splitmix32(s ^ (int(seed) & R.MASK32)))
    return torch.where(h == 0, torch.full_like(h, R.INITIAL_STATE), h)


# a pixel that hashes to 0 with sample 0 and seed 0: splitmix32's input
# for an output of 0 is -0x9E3779B9 mod 2**32 (its multiplies and
# xor-shifts map 0 to 0), so pix ^ splitmix32(0) must be that
ZERO_PIX = int(R.splitmix32(torch.tensor(0))) ^ ((-0x9E3779B9) & R.MASK32)


def _seed_arg(seed: int, form: str):
    return seed if form == "int" else WB.seed_word(seed, CPU)


@pytest.mark.parametrize("form", ["int", "word"])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 7, 2 ** 32 - 1])
def test_seed_perf_gives_the_inline_stream_seed(seed, form):
    g = torch.Generator().manual_seed(seed % 1000)
    pix = torch.cat([torch.tensor([0, 0, 1, 479_999]),
                     torch.randint(0, 2 ** 31, (256,), generator=g)])
    s = torch.cat([torch.tensor([0, 1, 0, 99]),
                   torch.randint(0, 2 ** 20, (256,), generator=g)])
    got = R.seed_perf(pix, s, _seed_arg(seed, form))
    assert got.dtype == torch.int64
    assert torch.equal(got, _inline(pix, s, seed))
    assert bool((got != 0).all())


@pytest.mark.parametrize("form", ["int", "word"])
def test_seed_perf_maps_a_zero_hash_to_the_start_state(form):
    pix = torch.tensor([ZERO_PIX, ZERO_PIX ^ 1])
    s = torch.zeros(2, dtype=torch.int64)
    raw = R.splitmix32(pix ^ R.splitmix32(s))
    assert int(raw[0]) == 0 and int(raw[1]) != 0
    got = R.seed_perf(pix, s, _seed_arg(0, form))
    assert got.tolist() == [R.INITIAL_STATE, int(raw[1])]
    assert torch.equal(got, _inline(pix, s, 0))


def test_seed_perf_reads_nothing_back_from_the_seed_word():
    meta = torch.device("meta")
    pix = torch.zeros(8, dtype=torch.int64, device=meta)
    word = torch.full((), 5, dtype=torch.int64, device=meta)
    with pytest.raises((RuntimeError, NotImplementedError)):
        int(word)                         # the meta device holds no number
    out = R.seed_perf(pix, pix, word)
    assert out.device == meta and out.shape == (8,)


# ---------------------------------------------------------------------------
# K1's inputs
# ---------------------------------------------------------------------------

def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_k1_inputs_equal_the_recipe_they_replace(scenes, name):
    scene, cam = scenes[name]
    tables, flat, n = wq.k1_inputs(scene, cam, 40, 30, 2 ** 32 - 3, CPU)
    want = WB.pack_scene(scene, CPU)._replace(
        cam=WB.pack_camera(cam, 40, 30, CPU),
        seed=WB.seed_word(2 ** 32 - 3, CPU))
    want_flat, want_n = wq._pack_atlas_flat(scene.textures.atlas.to(CPU))
    assert tables._fields == want._fields
    for f, a, b in zip(want._fields, tables, want):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), f
    assert n == want_n and torch.equal(flat, want_flat)
    assert (n > 1) == (name == "textured")


# ---------------------------------------------------------------------------
# the shared steps
# ---------------------------------------------------------------------------

def test_grant_takes_eligible_lanes_in_order_while_ids_are_left():
    elig = torch.zeros(2, 128, dtype=torch.bool)
    elig[0, [3, 7, 100]] = True
    elig[1, [0, 5]] = True
    counter = torch.tensor(10)
    granted, cid, new = wq.grant(elig, counter, 13)
    assert granted.nonzero().tolist() == [[0, 3], [0, 7], [0, 100]]
    assert cid[elig].tolist() == [10, 11, 12, 13, 14]
    assert int(new) == 13
    granted, _, new = wq.grant(elig, new, torch.tensor(13))
    assert not granted.any() and int(new) == 13


def test_bank_fills_slot_0_first_and_only_for_a_held_chunk():
    st = wq._zeros_state(1, CPU)
    st = st._replace(pix=(torch.arange(128.0) - 1.0).reshape(1, 128),
                     accx=(torch.arange(128.0) + 0.5).reshape(1, 128))
    ex = wq._zeros_extra(1, CPU)
    ex = ex._replace(bpix0=torch.where(torch.arange(128) % 2 == 0, -1.0,
                                       9.0).reshape(1, 128))
    granted = (torch.arange(128) < 6).reshape(1, 128)
    out = wq.bank(st, ex, granted)
    # lane 0 holds no chunk; lanes 2, 4 find slot 0 free, 1, 3, 5 do not
    assert out.bpix0[0, :6].tolist() == [-1.0, 9.0, 1.0, 9.0, 3.0, 9.0]
    assert out.bpix1[0, :6].tolist() == [-1.0, 0.0, -1.0, 2.0, -1.0, 4.0]
    assert out.br1[0, 1] == st.accx[0, 1] and out.br0[0, 2] == st.accx[0, 2]
    assert torch.equal(out.bpix0[0, 6:], ex.bpix0[0, 6:])


# ---------------------------------------------------------------------------
# the recorders, pinned
# ---------------------------------------------------------------------------

# a 2-step stage A on one row: chunks of 2 are cut at the boundary, so
# stage B grants leftover singles; the last 64 pixels are tail singles
REC = dict(max_depth=4, seed=5, window=2, max_steps=2, rows=1, rows_b=1,
           tile_rows=1, tile_rows_b=1)

# (fb, stage A's planes, stage B's, perm + pvalid, ok): recorded before
# the recorder's refill called the shared steps
PINNED_Q = {
    "cornell": ["bc65aec8c3f47227", "d9efbfbec6bb4b0f", "48d4ac9bac9660ac",
                "8656aacd77158309", True],
    "textured": ["5fd91d27f9eae884", "12ebfcd6a73d91c5", "3fb88ecd3ebdb530",
                 "2024fb9f7cc53afd", True],
}


@pytest.mark.parametrize("name", sorted(PINNED_Q))
def test_queued_recorder_gives_the_pinned_bits(scenes, monkeypatch, name):
    scene, cam = scenes[name]
    rcfg = TQ.render_grad_fb(16, 12, 16 * 12, 2, device=CPU, **REC).rcfg
    totals = []
    real = wq.grant

    def spy(elig, counter, n_total):
        totals.append(int(n_total))
        return real(elig, counter, n_total)

    monkeypatch.setattr(wq, "grant", spy)
    fb, rec, ok = TQ.record_forward_q(scene, cam, 16, 12, 0, 0, **rcfg)
    assert [_digest(fb), _digest(*rec.a), _digest(*rec.b),
            _digest(rec.perm, rec.pvalid), bool(ok)] == PINNED_Q[name]
    n_chunks = (16 * 12 - rcfg["tail_pix"]) + rcfg["tail_pix"] * 2
    assert rcfg["tail_pix"] > 0 and rcfg["chunk"] == 2
    assert totals[0] == n_chunks and max(totals) > n_chunks   # lo is used


# (radiance, residuals): recorded before the pinned recorder called
# `k1_inputs` and `seed_perf`
PINNED_PINNED = {
    "cornell": ["856160d53c46bd8e", "9323546a41e57f85"],
    "textured": ["315c831897dac679", "9918412cf314657d"],
}


@pytest.mark.parametrize("name", sorted(PINNED_PINNED))
def test_pinned_recorder_gives_the_pinned_bits(scenes, name):
    scene, cam = scenes[name]
    pix = torch.arange(300) % 192
    samp = torch.arange(300) // 192 + 3
    rad, res = PV.record_forward(scene, cam, 16, 12, pix, samp, max_depth=4,
                                 attenuate=True, t_min=1e-3, seed=5,
                                 tile_rows=1, device=CPU)
    assert [_digest(rad), _digest(*res)] == PINNED_PINNED[name]
