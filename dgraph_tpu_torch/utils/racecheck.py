"""Sampled attribute-level data-race witness: dglint DG13's dynamic
complement (as utils/lockcheck is DG12's).

The reference Dgraph keeps its Raft/txn/move machinery honest with
`go test -race`; this module restores a slice of that safety net for
the Python port. Under tests (opt-in via the `racecheck` pytest
marker), a registry of project classes gets its `__setattr__` and
`__getattribute__` instrumented: every sampled attribute access
records (object, attr, thread, kind, lockset) where the lockset is the
calling thread's held-lock stack already maintained by
utils/lockcheck. Two accesses to the same (object, attr) from
different threads, at least one a write, with NO common lock and no
witnessed happens-before edge between them, raise `RaceViolation`
carrying both access stacks — the Python rendition of a TSan report.

Design constraints (a lockset sampler in the Eraser lineage, not a
vector-clock TSan):

  - OPT-IN per-class registry (`TARGETS` / `register()`): wholesale
    `__getattribute__` wrapping would tax every test; the registry
    names the concurrency-plane classes the static half (DG13) cares
    most about, with per-class ignore sets for intentional lock-free
    publishes (e.g. CdcPlane.on_invalidate, a write-once observer);
  - reads are only witnessed for attributes some write has touched
    (per-class written-attr set): a read of never-written state — a
    method, a class constant — costs one set probe and no record;
  - locksets come from lockcheck's thread-local held stacks (enable()
    arms lockcheck's lock wrapping if the test did not), so lock
    identity is the same construction-site name DG12/DG13 use; the
    candidate lockset of each (obj, attr, thread, kind) record is the
    INTERSECTION over its accesses (Eraser's refinement), its stack
    the first-seen one — steady-state cost per sampled access is a
    few dict probes, stacks are captured only on first record or
    violation, via a fast manual frame walk (no linecache I/O);
  - happens-before is witnessed coarsely through thread lifecycle:
    `Thread.start()` retires the PARENT's prior records (everything
    the parent did happens-before the child's first step) and
    `Thread.join()` retires the JOINED thread's records (and with
    them any alias from thread-id reuse) — the classic
    construct-then-spawn and join-then-read patterns are not races.
    Queue/Future handoffs between two long-lived threads are NOT
    modeled; state published that way belongs in a per-class ignore
    set or a dglint guarded-by discipline annotation, not silently
    unsampled;
  - only objects CONSTRUCTED while the witness is armed are
    witnessed (the `_born` registry): an older object's locks predate
    lockcheck's factory patch, so its guarded accesses would all show
    empty locksets — unwitnessable state can only false-positive.
    Module-scoped fixtures are therefore invisible by design; a test
    that wants them witnessed constructs them under the marker;
  - constructor writes are suppressed by an init-depth counter (an
    object under construction is thread-confined by definition) but
    still seed the written-attr set so later reads are witnessed;
  - the access table lives behind a raw `_thread.allocate_lock()` so
    the witness's own lock never enters lockcheck's order table or
    any held stack;
  - violations are recorded always and raised in the accessing thread
    only when `strict=True`; each (class, attr) pair reports at most
    once per armed window (a real race fires on every loop iteration
    — one report with both stacks is the signal, a thousand is log
    spam).

Overhead is budgeted, not hoped for: bench_micro.py's
`racecheck_overhead_bench` decomposes per-sampled-access cost ×
sampled-access count on the batcher workload and tools/check.sh gates
the product at < 5% (DGRAPH_TPU_RACECHECK_BUDGET).

Port of `dgraph_tpu/utils/racecheck.py`: a copy, its imports pointed at
this package: `TARGETS` name this package's classes, and the locksets
come from this package's `utils.lockcheck`.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
from typing import Iterable, Optional

from dgraph_tpu_torch.utils import lockcheck

__all__ = [
    "RaceViolation", "TARGETS", "register", "enable", "disable",
    "reset", "enabled", "violations", "stats",
]


class RaceViolation(AssertionError):
    """Two accesses to the same attribute from different threads, at
    least one a write, no common lock, no witnessed happens-before
    edge. Both witness stacks attached."""

    def __init__(self, cls_name: str, attr: str,
                 first_kind: str, first_thread: str, first_locks,
                 first_stack: str,
                 second_kind: str, second_thread: str, second_locks,
                 second_stack: str):
        self.cls_name = cls_name
        self.attr = attr
        self.first = (first_kind, first_thread, first_locks)
        self.second = (second_kind, second_thread, second_locks)
        word = {"r": "read", "w": "write"}
        super().__init__(
            f"data race on `{cls_name}.{attr}`: "
            f"{word[second_kind]} in thread {second_thread!r} holding "
            f"{sorted(second_locks) or '{}'} conflicts with "
            f"{word[first_kind]} in thread {first_thread!r} holding "
            f"{sorted(first_locks) or '{}'} — no common lock, no "
            "happens-before edge\n"
            f"--- first access ({word[first_kind]}, "
            f"{first_thread!r}) at:\n{first_stack}"
            f"--- second access ({word[second_kind]}, "
            f"{second_thread!r}) at:\n{second_stack}")


# Opt-in registry: (module, class, ignored attrs). These are the
# concurrency-plane classes PRs 15-18 grew — the ones whose races cost
# 3-6 review passes each. Ignores are intentional lock-free publishes,
# each mirrored by a dglint guarded-by annotation at the access site.
TARGETS = (
    ("dgraph_tpu_torch.engine.prefetch", "PrefetchPool", ()),
    ("dgraph_tpu_torch.engine.result_cache", "ResultCache", ()),
    ("dgraph_tpu_torch.engine.batcher", "MicroBatcher", ()),
    # on_invalidate: write-once observer wiring (engine attach time),
    # read lock-free by the apply path forever after; cap/raw_cap:
    # init-time config ints the truncation tests poke on live planes
    # (a GIL-atomic rebind the reader is allowed to see late)
    ("dgraph_tpu_torch.cdc.changelog", "CdcPlane",
     ("on_invalidate", "cap", "raw_cap")),
    ("dgraph_tpu_torch.cluster.client", "ClusterClient", ()),
)

_THIS_FILE = os.path.abspath(__file__)

_tls = threading.local()
# raw lock: never wrapped by lockcheck's factory, never in held stacks
_table_lock = _thread.allocate_lock()

# (id(obj), attr) -> {(tid, kind): [lockset, stack|None, epoch, name]}
_accesses: dict = {}
_born: set = set()              # ids constructed while armed
_tepoch: dict[int, int] = {}   # thread ident -> lifecycle epoch
_written: dict[type, set] = {}  # class -> attrs some write touched
_ignored: dict[type, frozenset] = {}
_violations: list[RaceViolation] = []
_reported: set = set()          # (cls_name, attr) dedup
_samples = 0                    # recorded accesses (overhead math)
_probes = 0                     # wrapper entries incl. unsampled reads
_enabled = False
_strict = False
_sample = 1                     # record every Nth witnessed read
_read_tick = 0
_extra: list[tuple] = []        # register()-added targets
_patched: dict = {}             # class -> original methods
_thread_orig: dict = {}
_own_lockcheck = False


def register(cls: type, ignore: Iterable[str] = ()) -> None:
    """Add a class to the witness registry (tests register fixture
    classes; product classes belong in TARGETS). Takes effect at the
    next enable()."""
    _extra.append((cls, tuple(ignore)))


def _fast_stack(limit: int = 12) -> str:
    """Manual frame walk: file:line/function only, no source-line
    lookup — cheap enough to capture inside the table lock."""
    f = sys._getframe(2)
    parts = []
    while f is not None and len(parts) < limit:
        fn = f.f_code.co_filename
        if fn != _THIS_FILE:
            parts.append(f"  {os.path.basename(fn)}:{f.f_lineno} "
                         f"in {f.f_code.co_name}")
        f = f.f_back
    parts.reverse()
    return "\n".join(parts) + "\n"


def _live(rec) -> bool:
    """A record is live while its thread's lifecycle epoch is
    unchanged; start()/join() bumps retire it (happens-before)."""
    return rec[2] == _tepoch.get(rec[4], 0)


def _lockset() -> frozenset:
    """The calling thread's held locks as a frozenset, cached per
    thread on the held tuple (it rarely changes between consecutive
    sampled accesses — the allocation is the steady-state cost)."""
    held = lockcheck.held_locks()
    if getattr(_tls, "lk_key", None) == held:
        return _tls.lk_fs
    fs = frozenset(held)
    _tls.lk_key = held
    _tls.lk_fs = fs
    return fs


def _record(cls: type, obj, attr: str, kind: str):
    global _samples
    if id(obj) not in _born:
        # constructed before arming: its locks are unwrapped (empty
        # locksets), so any record could only be a false positive
        return
    held_fs = _lockset()
    tid = _thread.get_ident()
    key = (id(obj), attr)
    k2 = (tid, kind)
    # Lock-free fast path: this thread already holds a live record for
    # (obj, attr, kind) with the same lockset — nothing to refine, and
    # the conflict scan already ran when the record was created (a
    # later conflicting access creates ITS record under the table
    # lock and scans against ours). Pure GIL-atomic dict reads.
    tbl = _accesses.get(key)
    if tbl is not None:
        rec = tbl.get(k2)
        if rec is not None \
                and (rec[0] is held_fs or rec[0] == held_fs) \
                and rec[2] == _tepoch.get(tid, 0):
            _samples += 1  # stat only: a lost racy increment is fine
            return
    v: Optional[RaceViolation] = None
    with _table_lock:
        if not _enabled:
            return
        _samples += 1
        ep = _tepoch.get(tid, 0)
        tbl = _accesses.get(key)
        if tbl is None:
            tbl = _accesses[key] = {}
        rec = tbl.get(k2)
        if rec is None or not _live(rec):
            rec = tbl[k2] = [held_fs, _fast_stack(), ep,
                             threading.current_thread().name, tid]
        elif held_fs is not rec[0] and held_fs != rec[0]:
            rec[0] &= held_fs  # Eraser refinement: candidate lockset
        dk = (cls.__name__, attr)
        if dk not in _reported and len(tbl) > 1:
            for (otid, okind), other in tbl.items():
                if otid == tid:
                    continue
                if kind != "w" and okind != "w":
                    continue
                if not _live(other):
                    continue
                if other[0] & held_fs:
                    continue
                _reported.add(dk)
                v = RaceViolation(
                    cls.__name__, attr,
                    okind, other[3], other[0],
                    other[1] or "  <stack not captured>\n",
                    kind, threading.current_thread().name,
                    held_fs, _fast_stack())
                _violations.append(v)
                break
    if v is not None and _strict:
        raise v


# ------------------------------------------------------ class patching


def _patch_class(cls: type, ignore: Iterable[str]):
    if cls in _patched:
        return
    ign = _ignored[cls] = frozenset(ignore)
    written = _written.setdefault(cls, set())
    orig_set = cls.__setattr__
    orig_get = cls.__getattribute__
    orig_init = cls.__init__
    _patched[cls] = (orig_set, orig_get, orig_init)

    def rc_setattr(self, name, value):
        if _enabled and name not in ign:
            written.add(name)
            if not getattr(_tls, "init_depth", 0):
                global _probes
                _probes += 1
                _record(cls, self, name, "w")
        orig_set(self, name, value)

    def rc_getattribute(self, name):
        val = orig_get(self, name)
        if _enabled and name in written and name not in ign \
                and not getattr(_tls, "init_depth", 0):
            global _probes, _read_tick
            _probes += 1
            _read_tick += 1  # racy increment: sampling, not counting
            if _read_tick % _sample == 0:
                _record(cls, self, name, "r")
        return val

    def rc_init(self, *a, **k):
        if _enabled:
            _born.add(id(self))  # GIL-atomic set add
        # an object under construction is thread-confined: suppress
        # records (the written-attr set still fills via rc_setattr)
        _tls.init_depth = getattr(_tls, "init_depth", 0) + 1
        try:
            orig_init(self, *a, **k)
        finally:
            _tls.init_depth -= 1

    cls.__setattr__ = rc_setattr
    cls.__getattribute__ = rc_getattribute
    cls.__init__ = rc_init


def _unpatch_classes():
    for cls, (orig_set, orig_get, orig_init) in _patched.items():
        cls.__setattr__ = orig_set
        cls.__getattribute__ = orig_get
        cls.__init__ = orig_init
    _patched.clear()
    _ignored.clear()


def _resolve_targets():
    import importlib

    out = []
    for mod, name, ignore in TARGETS:
        cls = getattr(importlib.import_module(mod), name)
        out.append((cls, ignore))
    out.extend(_extra)
    return out


# ------------------------------------------- thread lifecycle hooks


def _patch_threads():
    if _thread_orig:
        return
    _thread_orig["start"] = threading.Thread.start
    _thread_orig["join"] = threading.Thread.join

    def start(self):
        # everything the parent did happens-before the child's first
        # step: retire the parent's records
        with _table_lock:
            me = _thread.get_ident()
            _tepoch[me] = _tepoch.get(me, 0) + 1
        return _thread_orig["start"](self)

    def join(self, timeout=None):
        r = _thread_orig["join"](self, timeout)
        if not self.is_alive() and self.ident is not None:
            # the joined thread happens-before the joiner's next step
            # (also invalidates any id-reuse alias of its records)
            with _table_lock:
                _tepoch[self.ident] = _tepoch.get(self.ident, 0) + 1
        return r

    threading.Thread.start = start
    threading.Thread.join = join


def _unpatch_threads():
    if not _thread_orig:
        return
    threading.Thread.start = _thread_orig["start"]
    threading.Thread.join = _thread_orig["join"]
    _thread_orig.clear()


# --------------------------------------------------------- lifecycle


def enable(strict: bool = False, sample: int = 1):
    """Arm the witness on every registered class. `sample=N` records
    every Nth witnessed read (writes are always recorded); `strict`
    additionally raises in the accessing thread. Arms lockcheck's
    lock wrapping too (held stacks are the locksets) when the test
    has not already done so."""
    global _enabled, _strict, _sample, _own_lockcheck

    reset()
    _strict = bool(strict)
    _sample = max(1, int(sample))
    if _enabled:
        return
    if not lockcheck.enabled():
        lockcheck.enable()
        _own_lockcheck = True
    for cls, ignore in _resolve_targets():
        _patch_class(cls, ignore)
    _patch_threads()
    _enabled = True


def disable() -> list[RaceViolation]:
    """Disarm and return the violations recorded while armed."""
    global _enabled, _own_lockcheck

    if _enabled:
        with _table_lock:
            _enabled = False
        _unpatch_classes()
        _unpatch_threads()
        if _own_lockcheck:
            lockcheck.disable()
            _own_lockcheck = False
    return list(_violations)


def reset():
    global _samples, _probes, _read_tick

    with _table_lock:
        _accesses.clear()
        _born.clear()
        _tepoch.clear()
        _violations.clear()
        _reported.clear()
        _written.clear()
        _samples = 0
        _probes = 0
        _read_tick = 0


def enabled() -> bool:
    return _enabled


def violations() -> list[RaceViolation]:
    return list(_violations)


def stats() -> dict:
    return {"probes": _probes, "samples": _samples,
            "tracked_keys": len(_accesses),
            "violations": len(_violations)}
