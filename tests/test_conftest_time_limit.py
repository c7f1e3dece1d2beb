"""The per-test time limit (tests/time_limit.py), held in inner pytest
sessions whose conftest registers it and lowers the limit to 1 s and the
hard stop to 0.2 s after it."""

from pathlib import Path

pytest_plugins = "pytester"

CONFTEST = """
import time_limit

time_limit.LIMIT_S = 1
time_limit.HARD_STOP_S = 0.2


def pytest_configure(config):
    config.pluginmanager.register(time_limit)
"""

# test_deaf blocks SIGALRM, so the hard stop ends it, 1.2 s after it starts.
DEAF = """
import signal
import time
from pathlib import Path

def test_deaf():
    Path(__file__).with_name("deaf.started").touch()
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(30)

def test_after_the_stop():
    pass

def test_after_that():
    pass
"""

# A test that ends `end` s after test_deaf starts, under the 1 s limit.
ENDS_AFTER_DEAF = """
import time
from pathlib import Path

def test_{name}():
    started = Path(__file__).with_name("deaf.started")
    while not started.exists():
        time.sleep(0.01)
    time.sleep(max(0.0, started.stat().st_mtime + {end} - time.time()))
"""


def _run(pytester, monkeypatch, files, *args):
    monkeypatch.setenv("PYTHONPATH", str(Path(__file__).resolve().parent))
    monkeypatch.setenv("PYTEST_DISABLE_PLUGIN_AUTOLOAD", "1")
    pytester.makeconftest(CONFTEST)
    pytester.makepyfile(**files)
    return pytester.runpytest_subprocess("-p", "no:cacheprovider", *args,
                                         timeout=60)


def test_a_test_past_the_limit_fails_by_name_and_the_next_runs(
        pytester, monkeypatch):
    result = _run(pytester, monkeypatch, {"test_inner": """
        def test_spins():
            while True:
                pass

        def test_after_the_spin():
            pass
    """}, "-v")
    result.assert_outcomes(passed=1, failed=1)
    result.stdout.fnmatch_lines([
        "test_inner.py::test_spins FAILED*",
        "test_inner.py::test_after_the_spin PASSED*",
        "*Failed: test_inner.py::test_spins ran * s, past the 1 s limit*"])


def test_setup_call_and_teardown_share_one_limit(pytester, monkeypatch):
    result = _run(pytester, monkeypatch, {"test_inner": """
        import time

        import pytest

        @pytest.fixture
        def slow_setup():
            time.sleep(0.6)
            yield

        def test_quick():
            time.sleep(0.1)

        def test_slow_in_two_parts(slow_setup):
            time.sleep(0.6)
    """}, "-v")
    result.assert_outcomes(passed=1, failed=1)
    result.stdout.fnmatch_lines([
        "test_inner.py::test_quick PASSED*",
        "test_inner.py::test_slow_in_two_parts FAILED*",
        "*Failed: test_inner.py::test_slow_in_two_parts ran * s, past the 1 s"
        " limit*"])


def test_code_deaf_to_the_alarm_is_stopped_and_its_file_goes_on(
        pytester, monkeypatch):
    """Under xdist with -q and --dist loadfile, as tier-1 runs: the worker
    in test_deaf ends, and its report holds the stack.  xdist queues again
    both files the worker was given, test_0.py finished; its replacement
    runs the rest of test_a.py, and not test_deaf."""
    result = _run(pytester, monkeypatch, {
        "test_0": "def test_1():\n    pass\n\n\ndef test_2():\n    pass\n"
                  "\n\ndef test_3():\n    pass\n",
        "test_a": DEAF,
    }, "-q", "-p", "xdist.plugin", "-n", "1", "--dist", "loadfile")
    result.assert_outcomes(passed=5, failed=1)
    assert result.stdout.str().count("crashed while running") == 1
    # The progress dots keep lines of their own, as tier-1 counts them.
    result.stdout.re_match_lines([r"[.]+$", r"\[gw\d\] node down: "])
    result.stdout.fnmatch_lines([
        "*worker 'gw0' crashed while running 'test_a.py::test_deaf'",
        "Timeout (0:00:01.200000)!", "*line * in test_deaf"])


def test_a_stopped_test_handed_to_another_worker_is_not_run_again(
        pytester, monkeypatch):
    """xdist queues the rest of test_a.py again, test_deaf first, and hands
    it at once to the other worker, which has taken the last file,
    test_d.py, while test_c waits for the stop.  That worker runs
    test_a.py's other tests and not test_deaf: test_b ends before the stop,
    test_c after."""
    result = _run(pytester, monkeypatch, {
        "test_a": DEAF,
        "test_b": ENDS_AFTER_DEAF.format(name="b", end=0.6),
        "test_c": ENDS_AFTER_DEAF.format(name="c", end=1.5),
        "test_d": "def test_d():\n    pass\n",
    }, "-q", "-p", "xdist.plugin", "-n", "2", "--dist", "loadfile")
    result.assert_outcomes(passed=5, failed=1)
    assert result.stdout.str().count("crashed while running") == 1
