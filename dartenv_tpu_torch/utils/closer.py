"""Closer (reference: `gym/utils/closer.py` † — SURVEY.md §2.1): registry
ensuring registered objects get closed at exit, exactly once."""
from __future__ import annotations

import atexit
import threading
import weakref


class Closer(object):
    """Tracks closeables and closes any still-registered ones at exit.

    Objects register themselves (must expose `close()`); they should
    unregister when closed manually.  Only weak references are held, so
    registration never keeps an object alive.
    """

    def __init__(self, atexit_register: bool = True):
        self.lock = threading.Lock()
        self.next_id = -1
        self.closeables: dict = {}
        if atexit_register:
            atexit.register(self.close)

    def generate_next_id(self) -> int:
        with self.lock:
            self.next_id += 1
            return self.next_id

    def register(self, closeable) -> int:
        assert hasattr(closeable, "close"), (
            "No close method for {}".format(closeable)
        )
        next_id = self.generate_next_id()
        self.closeables[next_id] = weakref.ref(closeable)
        return next_id

    def unregister(self, id) -> None:
        assert id is not None
        if id in self.closeables:
            del self.closeables[id]

    def close(self) -> None:
        # explicitly fetch all to avoid mutation-during-iteration
        closeables = list(self.closeables.values())
        for ref in closeables:
            obj = ref()
            if obj is not None:
                obj.close()
