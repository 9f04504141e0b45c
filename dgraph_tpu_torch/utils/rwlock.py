"""Reader-writer lock for the server front ends.

The reference gets read concurrency from Go's per-list RWMutex + MVCC
(posting/list.go RLock readers, goroutine-per-request); the in-process
engine equivalent is one server-level RW lock: snapshot reads share,
writes are exclusive. Writer-preference so a mutation burst cannot be
starved by a steady query stream.

Port of `dgraph_tpu/utils/rwlock.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import threading


class RWLock:
    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    # -- read side --

    def acquire_read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    # -- write side --

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    # -- context managers --

    @property
    def read(self):
        return _Guard(self.acquire_read, self.release_read)

    @property
    def write(self):
        return _Guard(self.acquire_write, self.release_write)


class _Guard:
    __slots__ = ("_enter", "_exit")

    def __init__(self, enter, exit_):
        self._enter = enter
        self._exit = exit_

    def __enter__(self):
        self._enter()
        return self

    def __exit__(self, *exc):
        self._exit()
        return False
