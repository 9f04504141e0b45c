"""Runtime lock-order witness: a mini-TSan for the test suite.

dglint DG12 proves lock-order acyclicity for every acquisition it can
attribute statically; callbacks, dynamic dispatch and data-dependent
paths stay invisible to it. This module is the dynamic complement:
under tests (opt-in via the `lockcheck` pytest marker), every lock the
project creates is witness-wrapped, acquisitions maintain a
thread-local held stack, and the FIRST time lock B is taken while A is
held the edge A -> B is recorded with its acquisition stack. A later
acquisition of A while B is held is an inversion: both stacks — the
recorded first-seen one and the current one — are attached to the
violation, and the owning test fails.

Design constraints (mirrors Go's lock-rank witness, not a full TSan):

  - thread-local acquisition stacks via `threading.local()` —
    deliberately contextvar-free, since locks are a thread property
    and an executor-hopping task must NOT drag its held-set along;
  - lock identity = construction site (`file:line`), so every
    instance of a class shares one rank and cross-instance inversions
    of the same lock pair are caught (same granularity as DG12's
    `Class.attr` identity);
  - stacks are captured ONLY when an edge is first seen or violated
    (rare); the per-acquisition cost is a list walk of the held stack
    plus one dict probe per held lock — the overhead budget on the
    lock-heavy batcher workload is < 3% (tests/test_lockcheck.py
    enforces it, decomposed like the tools/check.sh stats gate);
  - `enable()` patches `threading.Lock` (the factory) so locks
    created AFTER enable are wrapped — pre-existing locks (pytest's
    own, the interpreter's) stay untouched — and hooks the project's
    RWLock so reader/writer acquisition shares the same order table.
    Writer preference inside RWLock lives on an internal Condition
    and is invisible here by design: an RWLock is ONE name in the
    order table, whatever mode it was taken in.

Violations are recorded always and raised in the acquiring thread
only when `strict=True` (product threads swallowing an exception must
not hide the report — the conftest fixture fails the test off the
recorded list either way).

Port of `dgraph_tpu/utils/lockcheck.py`: a copy, its imports pointed at
this package. It ranks the locks built in this package's files and hooks
this package's `utils.rwlock.RWLock`; never arm it beside the
reference's witness, since both patch `threading.Lock` for the whole
process.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Optional

__all__ = [
    "LockOrderViolation", "enable", "disable", "reset", "enabled",
    "violations", "stats", "wrap_lock", "held_locks",
]


class LockOrderViolation(AssertionError):
    """Locks acquired in both orders: `acquiring` was taken while
    `held` was held, but the order `acquiring` -> `held` had been
    established earlier. Both witness stacks attached."""

    def __init__(self, held: str, acquiring: str, first_stack: str,
                 second_stack: str):
        self.edge = (held, acquiring)
        self.first_stack = first_stack   # the earlier acquiring->held
        self.second_stack = second_stack  # now: acquiring under held
        super().__init__(
            f"lock-order inversion: `{acquiring}` acquired while "
            f"holding `{held}`, but the order `{acquiring}` -> "
            f"`{held}` was established earlier\n"
            f"--- first-seen `{acquiring}` -> `{held}` at:\n"
            f"{first_stack}"
            f"--- now `{acquiring}` (holding `{held}`) at:\n"
            f"{second_stack}")


# each thread's held stack; reset() swaps in a new local, so a stack left
# by an earlier armed window (a lock acquired while armed, released after
# disable) is dropped in every thread at once
_tls = threading.local()
_table_lock = threading.Lock()  # guards _edges/_violations mutation
_edges: dict[tuple[str, str], str] = {}   # (a, b) -> first-seen stack
_violations: list[LockOrderViolation] = []
_acquires = 0           # total witnessed acquisitions (overhead math)
_enabled = False
_strict = False
_orig_lock = None
_rwlock_orig: dict[str, object] = {}

_THIS_FILE = os.path.abspath(__file__)
# witness scope: only locks CONSTRUCTED by project code are wrapped
# (wrapping torch/stdlib internals would both cost overhead and report
# third-party ordering protocols the project does not own)
_PROJECT_ROOT = os.path.dirname(os.path.dirname(_THIS_FILE))


def _held() -> list[str]:
    try:
        return _tls.held
    except AttributeError:
        h = _tls.held = []
        return h


def _site_frame():
    """Nearest stack frame outside this module and threading.py."""
    import sys

    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn != _THIS_FILE and not fn.endswith("threading.py"):
            return f
        f = f.f_back
    return None


def _site() -> str:
    f = _site_frame()
    if f is None:
        return "<unknown>"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def _stack() -> str:
    return "".join(traceback.format_stack(limit=14)[:-2])


def _check_acquire(name: str):
    """Order check BEFORE blocking on the real lock: a would-deadlock
    attempt is reported even if it never returns."""
    global _acquires
    _acquires += 1
    held = _held()
    if held and name not in held:  # reentrant/same-rank: never an edge
        _record_edges(held, name)


def _record_edges(held: list[str], name: str):
    """Each held lock -> `name`, first seen or an inversion."""
    for outer in dict.fromkeys(held):
        edge = (outer, name)
        rev = (name, outer)
        if edge in _edges:
            continue
        with _table_lock:
            if edge in _edges:
                continue
            first_stack = _edges.get(rev)
            if first_stack is not None:
                v = LockOrderViolation(outer, name, first_stack,
                                       _stack())
                _violations.append(v)
                if _strict:
                    raise v
                continue
            _edges[edge] = _stack()


def _push(name: str):
    _held().append(name)


def _pop(name: str):
    held = _held()
    if held and held[-1] == name:
        held.pop()
        return
    for i in range(len(held) - 2, -1, -1):
        if held[i] == name:
            del held[i]
            return


class _WitnessLock:
    """Duck-compatible stand-in for `threading.Lock()` while the
    witness is enabled. Everything the stdlib expects of a lock
    (Condition's probe-release dance included) delegates to the real
    lock; the order table sees acquire/release."""

    __slots__ = ("_real", "_name")

    def __init__(self, real, name: str):
        self._real = real
        self._name = name

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if _enabled:
            _check_acquire(self._name)
        got = self._real.acquire(blocking, timeout)
        if got and _enabled:
            _held().append(self._name)
        return got

    def release(self):
        # pop unconditionally: a lock acquired while armed may be
        # released after disable(); gating on _enabled would leave a
        # phantom held entry in this thread forever (_pop of an
        # un-pushed name is a no-op, so the unarmed case is free)
        _pop(self._name)
        self._real.release()

    def locked(self) -> bool:
        return self._real.locked()

    # the with-statement is the hot path: acquire() and release()
    # inlined, since every call layer adds to the per-acquire overhead
    # that the budget on the batcher workload counts
    def __enter__(self):
        global _acquires
        name = self._name
        if _enabled:
            _acquires += 1
            held = _held()
            if held and name not in held:
                _record_edges(held, name)
            self._real.acquire()
            if _enabled:
                _held().append(name)
        else:
            self._real.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        _pop(self._name)
        self._real.release()
        return False

    def __repr__(self):
        return f"<WitnessLock {self._name} of {self._real!r}>"


def wrap_lock(lock=None, name: Optional[str] = None) -> _WitnessLock:
    """Explicitly witness-wrap a lock (for locks created before
    enable(), or for naming one by hand in a test)."""
    real = lock if lock is not None else (
        _orig_lock() if _orig_lock is not None else
        threading.Lock())
    return _WitnessLock(real, name or _site())


def _lock_factory():
    f = _site_frame()
    if f is None or not os.path.abspath(
            f.f_code.co_filename).startswith(_PROJECT_ROOT):
        # a lock created by torch/stdlib/test-framework internals:
        # not the project's to rank — hand back a real lock
        return _orig_lock()
    return _WitnessLock(
        _orig_lock(),
        f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}")


# ------------------------------------------------------ RWLock hooks


def _patch_rwlock():
    from dgraph_tpu_torch.utils import rwlock as _rw

    if _rwlock_orig:
        return
    _rwlock_orig.update({
        "__init__": _rw.RWLock.__init__,
        "acquire_read": _rw.RWLock.acquire_read,
        "release_read": _rw.RWLock.release_read,
        "acquire_write": _rw.RWLock.acquire_write,
        "release_write": _rw.RWLock.release_write,
    })

    def init(self, *a, **k):
        _rwlock_orig["__init__"](self, *a, **k)
        self._lc_name = f"rw@{_site()}"

    def _name(self) -> str:
        n = getattr(self, "_lc_name", None)
        if n is None:
            n = self._lc_name = "rw@<pre-enable>"
        return n

    def acquire_read(self):
        if _enabled:
            _check_acquire(_name(self))
        _rwlock_orig["acquire_read"](self)
        if _enabled:
            _push(_name(self))

    def release_read(self):
        _pop(_name(self))  # unconditional: see _WitnessLock.release
        _rwlock_orig["release_read"](self)

    def acquire_write(self):
        if _enabled:
            _check_acquire(_name(self))
        _rwlock_orig["acquire_write"](self)
        if _enabled:
            _push(_name(self))

    def release_write(self):
        _pop(_name(self))  # unconditional: see _WitnessLock.release
        _rwlock_orig["release_write"](self)

    _rw.RWLock.__init__ = init
    _rw.RWLock.acquire_read = acquire_read
    _rw.RWLock.release_read = release_read
    _rw.RWLock.acquire_write = acquire_write
    _rw.RWLock.release_write = release_write


def _unpatch_rwlock():
    from dgraph_tpu_torch.utils import rwlock as _rw

    if not _rwlock_orig:
        return
    _rw.RWLock.__init__ = _rwlock_orig["__init__"]
    _rw.RWLock.acquire_read = _rwlock_orig["acquire_read"]
    _rw.RWLock.release_read = _rwlock_orig["release_read"]
    _rw.RWLock.acquire_write = _rwlock_orig["acquire_write"]
    _rw.RWLock.release_write = _rwlock_orig["release_write"]
    _rwlock_orig.clear()


# --------------------------------------------------------- lifecycle


def enable(strict: bool = False):
    """Arm the witness: locks created from here on are wrapped, the
    order table starts empty. `strict=True` additionally raises the
    violation in the acquiring thread (deterministic unit tests);
    the recorded list is authoritative either way."""
    global _enabled, _strict, _orig_lock

    reset()
    _strict = strict
    if not _enabled:
        _orig_lock = threading.Lock
        threading.Lock = _lock_factory
        _patch_rwlock()
        _enabled = True


def disable() -> list[LockOrderViolation]:
    """Disarm and return the violations recorded while armed.
    Witness-wrapped locks created during the window keep working
    (their hooks become no-ops once disabled)."""
    global _enabled, _orig_lock

    if _enabled:
        threading.Lock = _orig_lock
        _orig_lock = None
        _unpatch_rwlock()
        _enabled = False
    return list(_violations)


def reset():
    global _acquires, _tls

    with _table_lock:
        _edges.clear()
        _violations.clear()
        _acquires = 0
        _tls = threading.local()  # every thread's held stack starts empty


def enabled() -> bool:
    return _enabled


def held_locks() -> tuple:
    """The calling thread's currently-held witnessed locks, outermost
    first (lock identity = construction site, same as the order
    table). utils/racecheck consumes this as the lockset of each
    attribute access it samples."""
    return tuple(_held())


def violations() -> list[LockOrderViolation]:
    return list(_violations)


def stats() -> dict:
    return {"acquires": _acquires, "edges": len(_edges),
            "violations": len(_violations)}
