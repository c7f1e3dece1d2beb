"""A time limit for each test, with no plugin package (registered by the
repository's root conftest.py).

A test's setup, call and teardown share one budget of LIMIT_S seconds.
Past it, SIGALRM fails the test with its node id and the seconds it ran,
and the session goes on with the next test.  Code that does not return to
the interpreter never sees the signal (a stuck XLA compile, a wait on a
dead gloo rank): HARD_STOP_S seconds later faulthandler writes every
thread's stack and ends the process.  Under xdist the worker is then
replaced, and the test is reported as crashed with that stack.

Each test keeps a mark in a directory of the session while it runs, into
which an xdist worker's stack goes.  xdist hands a crashed worker's
unfinished tests to another worker, the crashed test first, and that test
would stop each worker that takes it: a test whose mark is already there
is not run again.

LIMIT_S is the smallest round figure above 1.5x the slowest test's time
in a run of the suite (6 xdist workers, 8 CPU cores) with an empty JAX
compilation cache: 384 s, tests/test_solvers.py::
test_sqp_warm_reg_tethers_to_warm_start.
"""

import faulthandler
import hashlib
import os
import shutil
import signal
import tempfile
import time
from pathlib import Path

import pytest

LIMIT_S = 600
HARD_STOP_S = 60

_START = pytest.StashKey[float]()
_STDERR = pytest.StashKey[int]()
_MARKS = pytest.StashKey[Path]()
_MARK = pytest.StashKey[object]()


def _mark(config, nodeid):
    return config.stash[_MARKS] / hashlib.sha1(nodeid.encode()).hexdigest()


def pytest_configure(config):
    worker = getattr(config, "workerinput", None)
    config.stash[_MARKS] = Path(worker["time_limit_marks"] if worker else
                                tempfile.mkdtemp(prefix="time-limit-"))
    # Output capture is off here; during a test fd 2 is a capture file,
    # which the hard stop's _exit would throw away with the stack.
    config.stash[_STDERR] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR])
    if not hasattr(config, "workerinput"):
        shutil.rmtree(config.stash[_MARKS], ignore_errors=True)


@pytest.hookimpl(optionalhook=True)
def pytest_configure_node(node):
    node.workerinput["time_limit_marks"] = str(node.config.stash[_MARKS])


@pytest.hookimpl(tryfirst=True, specname="pytest_runtest_protocol")
def pytest_runtest_protocol_once(item):
    config = item.config
    mark = _mark(config, item.nodeid)
    if mark.exists():   # a worker ended in it, and xdist reported it
        return True
    item.stash[_MARK] = stack = mark.open("w")
    item.stash[_START] = time.monotonic()
    faulthandler.dump_traceback_later(
        LIMIT_S + HARD_STOP_S, exit=True,
        file=stack if hasattr(config, "workerinput") else
        config.stash[_STDERR])


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item):
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        if _MARK in item.stash:
            item.stash[_MARK].close()
            os.unlink(item.stash[_MARK].name)


@pytest.hookimpl(tryfirst=True, optionalhook=True)
def pytest_testnodedown(node, error):
    # xdist's "node down" note would follow the progress dots on their
    # line, which a count of the dots per line then misses.
    reporter = node.config.pluginmanager.getplugin("terminalreporter")
    if error and reporter is not None:
        reporter.write("\n")


@pytest.hookimpl(optionalhook=True)
def pytest_handlecrashitem(crashitem, report, sched):
    # --dist loadfile queues again every file the crashed worker was given,
    # finished ones too; the worker that takes a finished one runs nothing
    # and waits for work until the session's own limit.
    queue = getattr(sched, "workqueue", {})
    done = [scope for scope, unit in queue.items() if all(unit.values())]
    for scope in done:
        del queue[scope]
    mark = _mark(sched.config, crashitem)
    if mark.exists():
        report.longrepr = f"{report.longrepr}\n{mark.read_text()}"


def _limit_phase(item):
    start = item.stash[_START]
    left = LIMIT_S - (time.monotonic() - start)
    if left <= 0:   # the teardown of a test that ran out: hard stop only
        return (yield)

    def fail(signum, frame):
        pytest.fail(f"{item.nodeid} ran {time.monotonic() - start:.0f} s, "
                    f"past the {LIMIT_S} s limit for one test")

    previous = signal.signal(signal.SIGALRM, fail)
    signal.setitimer(signal.ITIMER_REAL, left)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


pytest_runtest_setup = pytest_runtest_call = pytest_runtest_teardown = \
    pytest.hookimpl(wrapper=True)(_limit_phase)
