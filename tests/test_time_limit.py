"""The suite's lanes (the repository's root conftest.py): a test that runs
past the time limit fails by name and the run goes on to the next test,
and the `slow` marks of the JAX package's self-tests name tests that
exist."""
import ast
import pathlib

pytest_plugins = ["pytester"]

ROOT = pathlib.Path(__file__).resolve().parent.parent


def lanes(pytestconfig):
    return pytestconfig.pluginmanager.get_plugin(str(ROOT / "conftest.py"))


def test_a_test_past_the_limit_fails_and_the_run_goes_on(pytester,
                                                         pytestconfig):
    pytester.makepyfile(test_inner="""
        import time

        def test_sleeps_past_the_limit():
            time.sleep(60)

        def test_runs_after_it():
            pass
    """)
    result = pytester.runpytest_inprocess(
        "-v", "-p", "no:randomly",
        plugins=[lanes(pytestconfig).TimeLimit(1.0)])
    result.assert_outcomes(passed=1, failed=1)
    result.stdout.fnmatch_lines([
        "*test_inner.py::test_sleeps_past_the_limit FAILED*",
        "*test_inner.py::test_runs_after_it PASSED*",
        "*test_inner.py::test_sleeps_past_the_limit ran past the suite's "
        "time limit of 1 s*"])
    assert result.duration < 60       # the limit cut the sleep short


def test_the_slow_marks_name_jax_self_tests_that_exist(pytestconfig):
    listed = lanes(pytestconfig).SLOW_JAX_SELF_TESTS
    assert len(listed) == 29
    for name in listed:
        path, func = name.split("::")
        assert not pathlib.Path(path).name.startswith("test_torch_"), name
        tree = ast.parse((ROOT / path).read_text())
        assert func in {n.name for n in tree.body
                        if isinstance(n, ast.FunctionDef)}, name
