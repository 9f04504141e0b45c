"""Deterministic failpoints: named injection sites for chaos tests.

The reference builds its Jepsen nemeses from the outside (SIGKILL,
partitions, clock skew — contrib/jepsen/main.go); failpoints complement
that with *surgical*, deterministic faults inside the process, the
x/debug.go / gofail style: a named site in production code evaluates to
a no-op unless a test (or the DGRAPH_TPU_FAILPOINTS env var, for
subprocess clusters) armed an action for it.

Injection sites (grep `failpoint.fire`; the SITES registry below is
the authoritative list, dglint DG08-checked):
    transport.send      cluster/transport.py — before a Raft frame send
    tablet.apply        storage/tablet.py    — before a commit delta lands
    executor.level      query/executor.py    — every block/level boundary
    wal.append          storage/wal.py       — before a record frames
    snapshot.install    cluster/service.py   — before a raft snapshot restores
    txn.xstage          cluster/service.py   — before a 2PC fragment stages
    txn.xfinalize       cluster/service.py   — before a decided 2PC
                                               fragment's finalize applies

Actions (spec grammar, `;`-separated in the env var):
    sleep(S)      delay S seconds (float) at the site
    error(MSG)    raise FailpointError(MSG) from the site
    off           registered but inert (hit counting only)
    N*ACTION      only the first N hits run ACTION, then the point
                  goes inert (still counted) — deterministic "fail
                  twice then recover" schedules

Example: DGRAPH_TPU_FAILPOINTS='executor.level=sleep(0.2);tablet.apply=2*error(boom)'

Production cost: `fire()` is one falsy-dict check when nothing is
armed. Tests arm programmatically and MUST clear: tests/conftest.py
fails any test that leaks an armed failpoint.
"""

from __future__ import annotations

import os
import re
import threading
import time

ENV_VAR = "DGRAPH_TPU_FAILPOINTS"

# Registry of every production injection site (the names `fire()` is
# called with outside tests). dglint DG08 checks each literal
# `failpoint.fire("...")` in dgraph_tpu/ against this tuple, so a
# renamed or removed site cannot silently turn chaos tests into
# no-ops. Tests may arm ad-hoc fixture names freely.
SITES = (
    "transport.send",    # cluster/transport.py — before a Raft frame
    "tablet.apply",      # storage/tablet.py    — before a commit delta
    "executor.level",    # query/executor.py    — block/level boundary
    "wal.append",        # storage/wal.py       — before a record frames
    "snapshot.install",  # cluster/service.py   — before a raft snapshot
    #                      restores (error = apply path dies mid-install)
    "txn.xstage",        # cluster/service.py   — before a 2PC fragment
    #                      stages on a participant group
    "txn.xfinalize",     # cluster/service.py   — before a DECIDED 2PC
    #                      fragment's finalize applies (error = one
    #                      transient failed delivery; reconcile retries)
    "ingest.shuffle",    # ingest/distributed.py — before a map worker
    #                      streams one shuffle part to a reduce group
    #                      (sleep = slow link; error = worker dies and
    #                      its chunk is reassigned)
    "ingest.reduce",     # ingest/distributed.py — before a reduce
    #                      group reduces one predicate's spill runs
    "cdc.append",        # cdc/changelog.py     — before a committed
    #                      txn's ops tail into the change logs (error
    #                      behaves like a WAL append failure)
    "cdc.deliver",       # cdc/changelog.py     — on every subscriber
    #                      poll before entries are served (sleep =
    #                      slow delivery; error = failed poll, the
    #                      subscriber retries/resumes by offset)
    "vecstore.build",    # storage/vecstore.py  — before a quantized
    #                      ANN index trains over a clean base block
    #                      (error = build dies, exact tiers keep
    #                      serving; sleep = slow k-means)
    "move.snapshot_chunk",  # cluster/service.py — source side, before
    #                      one snapshot chunk of a live tablet move is
    #                      served (sleep = slow stream; error = chunk
    #                      delivery fails, the driver retries/re-begins)
    "move.catchup",      # cluster/service.py   — destination side,
    #                      before a CDC catch-up batch replicates
    #                      (sleep = lag stays high, the fence defers)
    "move.fence",        # cluster/service.py   — zero's driver, before
    #                      the single-predicate write fence is proposed
    "move.flip",         # cluster/service.py   — zero's driver, before
    #                      the ownership flip commits (error/SIGKILL
    #                      here = the crash-safety acceptance seam)
    "watchdog.capture",  # utils/watchdog.py    — before an incident
    #                      bundle writes (error = full disk at the
    #                      worst moment; the evaluator must survive)
)


class FailpointError(RuntimeError):
    """Raised by an armed error(...) action at its injection site."""


class _Point:
    __slots__ = ("action", "arg", "limit", "hits")

    def __init__(self, action: str, arg, limit):
        self.action = action  # "sleep" | "error" | "off"
        self.arg = arg
        self.limit = limit    # None = every hit, N = first N hits
        self.hits = 0


_LOCK = threading.Lock()
_ARMED: dict[str, _Point] = {}

_SPEC = re.compile(
    r"^(?:(?P<n>\d+)\*)?(?P<action>sleep|error|off)"
    r"(?:\((?P<arg>[^)]*)\))?$")


def _parse(spec: str) -> _Point:
    m = _SPEC.match(spec.strip())
    if m is None:
        raise ValueError(f"bad failpoint spec {spec!r} "
                         "(want [N*]sleep(S)|error(MSG)|off)")
    action = m.group("action")
    limit = int(m.group("n")) if m.group("n") else None
    arg = m.group("arg")
    if action == "sleep":
        arg = float(arg if arg else 0)
    return _Point(action, arg, limit)


def arm(name: str, spec: str):
    """Arm `name` with an action spec (parsed eagerly so a typo fails
    the arming test, not the production code path)."""
    pt = _parse(spec)
    with _LOCK:
        _ARMED[name] = pt


def disarm(name: str):
    with _LOCK:
        _ARMED.pop(name, None)


def clear():
    with _LOCK:
        _ARMED.clear()


def armed() -> list[str]:
    with _LOCK:
        return sorted(_ARMED)


def hits(name: str) -> int:
    with _LOCK:
        pt = _ARMED.get(name)
        return pt.hits if pt is not None else 0


def fire(name: str):
    """Evaluate the failpoint `name`. No-op (one dict check) unless a
    test armed it."""
    if not _ARMED:
        return
    with _LOCK:
        pt = _ARMED.get(name)
        if pt is None:
            return
        pt.hits += 1
        if pt.limit is not None and pt.hits > pt.limit:
            return
        action, arg = pt.action, pt.arg
    # act OUTSIDE the lock: a sleep must not serialize other sites
    if action == "sleep":
        time.sleep(arg)
    elif action == "error":
        raise FailpointError(
            arg if arg else f"failpoint {name} fired")


def arm_from_env(env: str | None = None):
    """Arm from DGRAPH_TPU_FAILPOINTS ('name=spec;name=spec') — how
    subprocess cluster nodes under chaos tests inherit failpoints.
    Unset/empty leaves everything inert (the production default)."""
    raw = os.environ.get(ENV_VAR, "") if env is None else env
    for part in raw.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, spec = part.partition("=")
        arm(name.strip(), spec)


arm_from_env()
