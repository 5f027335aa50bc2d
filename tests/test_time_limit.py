"""The per-test time limit (``tests/time_limit.py``): a test that runs past
its limit fails alone, with a message that names the limit, and the next test
in the same file still runs and passes."""

from tests import time_limit

pytest_plugins = ["pytester"]

INI = """
[pytest]
markers =
    time_limit(seconds): this test's time limit
"""

SLOW_THEN_FAST = """
import time

import pytest


@pytest.mark.time_limit(1)
def test_sleeps_past_its_limit():
    time.sleep(30)


def test_after_it():
    assert True
"""


def test_a_test_past_its_limit_fails_alone(pytester):
    pytester.makeini(INI)
    pytester.makepyfile(SLOW_THEN_FAST)
    result = pytester.runpytest_inprocess(
        "-p", "tests.time_limit", "--strict-markers", "-p", "no:cacheprovider")
    result.assert_outcomes(passed=1, failed=1)
    result.stdout.fnmatch_lines([
        "*test_sleeps_past_its_limit ran past its time limit of 1 s*"])
    assert result.duration < 20


def test_the_default_and_the_marker_set_the_limit(pytester):
    pytester.makeini(INI)
    items = pytester.getitems("""
import pytest

def test_default():
    pass

@pytest.mark.time_limit(900)
def test_marked():
    pass
""")
    assert [time_limit.limit_of(i) for i in items] == [
        time_limit.DEFAULT_SECONDS, 900.0]
