"""The lanes of the test suite under tests/: a time limit on every test of
the default lane, a share of the cores for each xdist worker, and the
`slow` marks of the frozen JAX package's minute-long self-tests.

tests/conftest.py sets JAX's platform up; this file leaves that alone
and holds only what decides which tests run in the default lane
(`-m "not slow"`, pytest.ini) and for how long.
"""
import faulthandler
import os
import signal
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(ROOT, "tests")

# Seconds one test may take, its setup (module fixtures included) and
# teardown counted: about twice the slowest test of the default lane on a
# loaded xdist worker.
TIME_LIMIT_S = 300.0

# The JAX package is frozen and the port tests against it, so its own
# tests change outcome only with jax or jaxlib; those that take over 60 s
# alone on a loaded worker run in the `slow` lane.  Seconds: each test
# alone, six files at once on a loaded 8-core host.
SLOW_JAX_SELF_TESTS = {
    "tests/test_app.py::test_checkpoint_resume_bitexact_wq": 233,
    "tests/test_app.py::test_checkpoint_identity_mismatch_ignored": 100,
    "tests/test_edge_grad.py::test_radius_grad_matches_fd_with_edge_term":
        119,
    "tests/test_edge_grad.py::test_center_grad_matches_fd_with_edge_term":
        70,
    "tests/test_grad.py::test_grad_albedo_matches_fd": 66,
    "tests/test_grad.py::test_grad_radius_finite": 79,
    "tests/test_grad.py::test_grad_dielectric_ior_finite_and_direction": 65,
    "tests/test_multiprocess.py::test_two_process_distributed_render": 124,
    "tests/test_pallas_vjp.py::test_albedo_grad_matches_jnp_and_fd": 287,
    "tests/test_pallas_vjp.py::"
    "test_light_intensity_grad_matches_jnp_and_fd": 283,
    "tests/test_pallas_vjp.py::"
    "test_geometry_and_camera_grads_finite_and_match_jnp": 299,
    "tests/test_pallas_vjp.py::test_metal_fuzz_grad_matches_fd_sky_config":
        242,
    "tests/test_pallas_vjp.py::test_dielectric_ior_grad_finite_matches_jnp":
        167,
    "tests/test_pallas_vjp.py::test_medium_density_grad_finite": 120,
    "tests/test_pallas_vjp.py::test_final_scene_grad_finite": 198,
    "tests/test_queued_vjp.py::test_replay_fb_matches_recorded_fb": 88,
    "tests/test_queued_vjp.py::test_variable_chunking_preserves_radiance":
        140,
    "tests/test_queued_vjp.py::test_attr_rows_hint_is_value_neutral": 297,
    "tests/test_ref_parity.py::test_parity_vs_committed_reference_golden":
        213,
    "tests/test_sharding.py::test_sharded_render_matches_single_device": 175,
    "tests/test_sharding.py::test_spp_axis_psum": 171,
    "tests/test_sharding.py::"
    "test_sharded_matches_render_perf_statistically": 111,
    "tests/test_sharding.py::test_train_step_runs_and_reduces_loss": 241,
    "tests/test_sharding.py::test_multihost_glue_single_process": 97,
    "tests/test_wq.py::test_wq_anchor_three_spheres": 96,
    "tests/test_wq.py::test_wq_anchor_cornell_emissive": 87,
    "tests/test_wq.py::test_wq_anchor_final_scene": 106,
    "tests/test_wq.py::test_wq_windowed_drain_stage_compaction": 82,
    "tests/test_wq.py::test_wq_windowed_matches_legacy_on_segments": 143,
}


def _under(path, folder):
    return os.path.commonpath([os.path.abspath(path), folder]) == folder


def pytest_configure(config):
    _budget_threads()
    config.pluginmanager.register(TimeLimit(TIME_LIMIT_S, under=TESTS),
                                  "time_limit")


@pytest.hookimpl(tryfirst=True)     # before `-m` deselects by mark
def pytest_collection_modifyitems(items):
    for item in items:
        name = "::".join([os.path.relpath(item.path, ROOT).replace(
            os.sep, "/"), getattr(item, "originalname", item.name)])
        if name in SLOW_JAX_SELF_TESTS:
            item.add_marker(pytest.mark.slow)


def _cores():
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:           # no affinity call on this platform
        return os.cpu_count() or 1


def _budget_threads():
    """Share the cores this process may use between xdist's workers:
    torch starts one intra-op thread per core in every worker, beside
    XLA's own pool.  The processes a test spawns inherit the share
    through OMP_NUM_THREADS."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        import torch
        share = max(1, _cores() // int(workers))
        torch.set_num_threads(share)
        os.environ.setdefault("OMP_NUM_THREADS", str(share))


class TimeLimit:
    """Fail a test of the default lane that runs past `seconds`, and go on
    with the next one (the `slow` lane holds the tests that need minutes).
    With `under`, only the tests in that folder are limited.

    SIGALRM is armed around each of the test's setup, call and teardown
    with what is left of its time, and raises in the main thread, where
    xdist runs the tests.  A test stuck in C code, where the alarm cannot
    raise, has its stacks dumped and its process ended by faulthandler
    30 s later: xdist reports the test as crashed and goes on with a new
    worker."""

    def __init__(self, seconds, under=None):
        self.seconds = seconds
        self.under = under
        self.deadline = None

    def _armed(self, item):
        if item.get_closest_marker("slow") or (
                self.under and not _under(item.path, self.under)):
            yield
            return

        def expire(signum, frame):
            pytest.fail(f"{item.nodeid} ran past the suite's time limit of "
                        f"{self.seconds:g} s", pytrace=False)

        left = max(self.deadline - time.monotonic(), 1e-3)
        previous = signal.signal(signal.SIGALRM, expire)
        outer = signal.setitimer(signal.ITIMER_REAL, left)[0]
        faulthandler.dump_traceback_later(left + 30.0, exit=True,
                                          file=sys.__stderr__)
        t0 = time.monotonic()
        try:
            yield
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            faulthandler.cancel_dump_traceback_later()
            signal.signal(signal.SIGALRM, previous)
            if outer:            # a run inside a test (pytester): give the
                outer = max(outer - (time.monotonic() - t0), 1e-3)
                signal.setitimer(signal.ITIMER_REAL, outer)  # enclosing
                faulthandler.dump_traceback_later(           # test its own
                    outer + 30.0, exit=True, file=sys.__stderr__)

    @pytest.hookimpl(hookwrapper=True)
    def pytest_runtest_setup(self, item):
        self.deadline = time.monotonic() + self.seconds
        yield from self._armed(item)

    @pytest.hookimpl(hookwrapper=True)
    def pytest_runtest_call(self, item):
        yield from self._armed(item)

    @pytest.hookimpl(hookwrapper=True)
    def pytest_runtest_teardown(self, item):
        yield from self._armed(item)
