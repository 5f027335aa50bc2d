"""A time limit for every test, as a pytest plugin (the repo's root
``conftest.py`` registers it).

Each phase of a test (setup, call, teardown) runs under ``SIGALRM``: a phase
that outlasts its limit fails with a message naming the limit, and the session
goes on with the next test in the same worker. The limit is
``DEFAULT_SECONDS`` unless the test carries ``@pytest.mark.time_limit(s)``
(declared in ``pytest.ini``). Off the main thread, or where the platform has
no ``SIGALRM``, tests run without a limit.

The alarm is checked between Python bytecodes, so a test blocked inside one
long native call (an XLA compile) fails when that call returns.
"""

import contextlib
import signal
import threading
import time

import pytest

# The slowest test of a whole run under ``-n 6`` on 8 cores took 177-226 s,
# and up to 379 s with its worker not pinned to its share of the cores: the
# limit leaves room for a machine that is that loaded.
DEFAULT_SECONDS = 600


def limit_of(item):
    marker = item.get_closest_marker("time_limit")
    return float(marker.args[0]) if marker else float(DEFAULT_SECONDS)


@contextlib.contextmanager
def _alarm(seconds, what):
    if (not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"{what} ran past its time limit of {seconds:g} s",
                    pytrace=False)

    start = time.monotonic()
    outer_handler = signal.signal(signal.SIGALRM, expire)
    outer_left, _ = signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, outer_handler)
        if outer_left:  # a limit around this one (pytester) runs on
            left = outer_left - (time.monotonic() - start)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-3))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _alarm(limit_of(item), f"setup of {item.nodeid}"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _alarm(limit_of(item), item.nodeid):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _alarm(limit_of(item), f"teardown of {item.nodeid}"):
        return (yield)
