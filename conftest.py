"""Suite-wide guard: keep every test process under the kernel's limit on
memory maps.

XLA:CPU maps several regions for each executable it compiles, and JAX keeps
every executable alive in its caches.  The solver tests that call
`dantzig_solve` eagerly compile anew on every call (about 1300 maps each):
`tests/test_refine_mixed.py` run alone ends at 64,946 maps, 584 short of
Linux's default `vm.max_map_count` of 65,530, and a process that reaches
the limit dies inside LLVM ("Cannot allocate memory", then SIGSEGV or
abort in `backend_compile_and_load`).  Whether a pytest-xdist worker gets
there depends on which tests the scheduler happens to hand it before that
file, so any change in the number of collected tests can tip a run over.

Before each test, a process that holds more than a third of the limit
drops JAX's caches.  Nothing follows from that but recompilation; no test
file and no test setting changes.
"""
import gc
import sys

_DEFAULT_LIMIT = 65530


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


def pytest_runtest_setup(item):
    jax = sys.modules.get("jax")
    if jax is not None and _maps_held() > _THRESHOLD:
        jax.clear_caches()
        gc.collect()
