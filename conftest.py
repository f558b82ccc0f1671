"""Suite-wide guards: keep every test process under the kernel's limit on
memory maps, and every test inside a time limit of its own.

Memory maps.  XLA:CPU maps several regions for each executable it
compiles, and JAX keeps every executable alive in its caches.  The solver
tests that call `dantzig_solve` eagerly compile anew on every call (about
1300 maps each): `tests/test_refine_mixed.py` run alone ends at 64,946
maps, 584 short of Linux's default `vm.max_map_count` of 65,530, and a
process that reaches the limit dies inside LLVM ("Cannot allocate memory",
then SIGSEGV or abort in `backend_compile_and_load`).  Whether a
pytest-xdist worker gets there depends on which tests the scheduler
happens to hand it before that file, so any change in the number of
collected tests can tip a run over.  Before each test, a process that
holds more than a third of the limit drops JAX's caches.  Nothing follows
from that but recompilation.

Time limits.  The suite runs under one clock for all of it, and a run cut
by that clock (exit 124) counts only the tests it reached and names none
as failing; one hung child process or stuck compile could spend a third of
it unseen.  So each test's call gets two limits: at `TEST_LIMIT_S` a
SIGALRM in the main thread (where pytest-xdist workers run their tests)
fails that test with `TimeLimitExceeded`, naming the test and the limit;
at `BACKSTOP_S`, for a test stuck inside C code where no signal handler
runs, `faulthandler` dumps every thread's stack and ends the process, which
xdist reports as a crashed worker and a failed test.  The slowest test,
`tests/test_refine_mixed.py::test_refine_mixed_monotone_and_lifts_plateau`,
took 278-382 s in loaded 6-worker runs of the suite, so the limits sit
well above it: they catch hangs, not slow tests.
"""
import contextlib
import faulthandler
import gc
import os
import signal
import sys
import threading

import pytest

_DEFAULT_LIMIT = 65530
TEST_LIMIT_S = 600
BACKSTOP_S = 660


def _map_limit() -> int:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return _DEFAULT_LIMIT


def _maps_held() -> int:
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:          # no procfs: nothing to measure, nothing to do
        return 0


_THRESHOLD = _map_limit() // 3


class TimeLimitExceeded(AssertionError):
    """A test ran past its time limit."""


_stderr = sys.__stderr__  # the backstop's dump; fd 2's copy once configured


@contextlib.contextmanager
def time_limit(name, soft=TEST_LIMIT_S, hard=BACKSTOP_S):
    """Fail the enclosed code with TimeLimitExceeded after `soft` seconds
    (main thread only) and end the process after `hard` seconds."""
    main = threading.current_thread() is threading.main_thread()
    if main:
        def overrun(signum, frame):
            raise TimeLimitExceeded(
                f"{name} ran past its time limit of {soft} s")

        old_handler = signal.signal(signal.SIGALRM, overrun)
        signal.setitimer(signal.ITIMER_REAL, soft)
    faulthandler.dump_traceback_later(hard, exit=True, file=_stderr)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        if main:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old_handler)


def pytest_configure(config):
    global _stderr
    _stderr = os.dup(2)     # outlives the capture of a test's output


def pytest_runtest_setup(item):
    jax = sys.modules.get("jax")
    if jax is not None and _maps_held() > _THRESHOLD:
        jax.clear_caches()
        gc.collect()


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with time_limit(item.nodeid):
        yield
