"""Named host spans of the program: `with span("env.reset"): ...` is a
torch.profiler.record_function range while a profiler runs, so the span
lands in its trace beside the card's kernels and copies, and a shared
no-op context otherwise, so an untraced step pays one flag read a span
and no dispatcher call."""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name):
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
