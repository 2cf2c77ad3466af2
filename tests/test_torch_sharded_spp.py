"""The sharded render and train step on two gloo ranks on the CPU, on a
(1x2) mesh: the samples split over the spp axis, the frame's pixels on
each rank.  The checks, sizes and tolerances of test_torch_sharded.py,
which runs the (2x1) mesh; a file of its own so that each holds one
reference train step.
"""
import pytest

from test_torch_sharded import (check_frame, check_grid, check_loss,
                                check_loss_falls, check_params,
                                check_same_params, run_both)


@pytest.fixture(scope="module")
def runs():
    return run_both((1, 2), "torch_sharded_spp")


def test_assembled_frame_matches_render_wq(runs):
    check_frame(runs)


def test_ranks_sit_on_the_grid(runs):
    check_grid(runs)


def test_loss_matches_reference(runs):
    check_loss(runs)


def test_updated_params_match_reference(runs):
    check_params(runs)


def test_ranks_end_with_the_same_params(runs):
    check_same_params(runs)


def test_two_steps_lower_the_loss(runs):
    check_loss_falls(runs)
