"""The drain-stage schedule of the port's work-queue render against the
reference's (tests/test_wq.py:69-96): 48x32 at tile_rows=8 is two tiles,
so the live lanes are compacted once into a 1-tile grid, with flush_acc
at the stage boundary and narrowed drain bounces.  Same envelope as
test_torch_wq.py; a compaction fault (a dropped live lane, an unflushed
accumulator, a bad permutation) moves whole pixels and fails it.  The
reference's render is read from the golden
tests/golden/jax_ref/torch_wq_drain.npz.
"""
import pytest

from test_torch_wq import assert_envelope, render_both


@pytest.fixture(scope="module")
def drain_48x32():
    return render_both("torch_wq_drain", 48, 32, 1, 6, tile_rows=8,
                       window=2)


def test_drain_stage_render_matches_reference(drain_48x32):
    assert_envelope(*drain_48x32)


def test_drain_stage_ran_on_a_narrowed_grid(drain_48x32):
    _, (_, segs, iters, lanes) = drain_48x32
    assert lanes < iters * 2048.0
    assert 0.0 < segs <= lanes
