"""The root conftest's per-test time limit, driven directly with small
limits (no pytest subprocess): an overrun fails with the test's name and
the limit, and a call inside the limit passes."""
import time

import pytest


@pytest.fixture(scope="module")
def limits(pytestconfig):
    """The root conftest module as pytest loaded it."""
    return pytestconfig.pluginmanager.getplugin(
        str(pytestconfig.rootpath / "conftest.py"))


def test_overrun_fails_naming_test_and_limit(limits):
    t0 = time.monotonic()
    with pytest.raises(limits.TimeLimitExceeded,
                       match=r"probe::overrun ran past its time limit of 1 s"):
        with limits.time_limit("probe::overrun", soft=1, hard=30):
            time.sleep(5)
    assert time.monotonic() - t0 < 2.5


def test_call_inside_the_limit_passes(limits):
    with limits.time_limit("probe::quick", soft=1, hard=30):
        time.sleep(0.2)
    time.sleep(1.0)          # the disarmed limit does not fire afterwards
