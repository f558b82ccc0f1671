"""Crash-resilient file writes (reference: `gym/utils/atomic_write.py` † —
SURVEY.md §5.3 "Monitor's crash-resilient atomic_write")."""
from __future__ import annotations

import contextlib
import os
import tempfile


@contextlib.contextmanager
def atomic_write(filepath, binary=False):
    """Write to a temp file in the same directory, fsync, then rename."""
    directory = os.path.dirname(os.path.abspath(filepath))
    mode = "wb" if binary else "w"
    fd, tmppath = tempfile.mkstemp(dir=directory)
    os.close(fd)
    try:
        with open(tmppath, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmppath, filepath)
        tmppath = None
    finally:
        if tmppath is not None and os.path.exists(tmppath):
            os.unlink(tmppath)
