"""Bounded slow-query/request log backing /debug/requests.

The reference keeps /debug surfaces for "what has this node been
doing" (x/metrics.go pprof + expvar). This module is the request-level
equivalent: two bounded views of completed requests —

  recent   the last _RECENT_MAX requests in arrival order
  slowest  the _SLOW_MAX highest-latency requests seen since reset

Each entry carries the op, trace_id (the handle into /debug/traces and
the merged Perfetto view), total latency, the per-phase breakdown when
the engine measured one (extensions.server_latency), and the outcome —
"ok", or how the request died ("shed", "deadline", "cancelled",
"aborted", "error") so overload/abort behavior is inspectable after
the fact.

The engine records successful query/mutate completions (it owns the
phase breakdown); the serving edges record every failure outcome
(sheds never reach the engine). Recording is a deque append + a
bounded heap push under one lock — cheap enough for every request.

Port of `dgraph_tpu/utils/reqlog.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import contextlib
import contextvars
import heapq
import itertools
import threading
import time
from collections import deque
from typing import Iterator, Optional

from dgraph_tpu_torch.utils import tracing

_RECENT_MAX = 256
_SLOW_MAX = 32

_lock = threading.Lock()
_recent: deque = deque(maxlen=_RECENT_MAX)
_slow_heap: list[tuple[float, int, dict]] = []  # min-heap of (ms, seq, rec)
_seq = itertools.count()

# the micro-batcher (engine/batcher.py) binds its dispatch id around
# the drive so the engine's query records join against the batch
# without threading an argument through db.query_json
_BATCH_CV: contextvars.ContextVar[str] = contextvars.ContextVar(
    "dgraph_tpu_reqlog_batch", default="")

# Completion observers (mirrors tracing.add_span_observer): each
# registered callable sees every record() dict AFTER it lands in the
# rings — the SLO burn-rate evaluator (utils/alerts.py) feeds its
# per-second outcome windows from here without the serving edges
# growing a second reporting path. Observers must be cheap and never
# raise; they run outside _lock.
_observers: list = []


def add_observer(fn) -> None:
    if fn not in _observers:
        _observers.append(fn)


def remove_observer(fn) -> None:
    try:
        _observers.remove(fn)
    except ValueError:
        pass


@contextlib.contextmanager
def bind_batch(batch_id: str) -> Iterator[None]:
    """Stamp `batch_id` on every record() inside the block (the
    micro-batcher wraps each batch dispatch)."""
    tok = _BATCH_CV.set(str(batch_id))
    try:
        yield
    finally:
        _BATCH_CV.reset(tok)


def record(op: str, trace_id: str = "", latency_ms: float = 0.0,
           outcome: str = "ok",
           breakdown: Optional[dict] = None,
           plan_key: str = "", batch_id: str = "",
           tenant: str = "") -> None:
    """`plan_key` is the compiled plan's 16-hex skeleton hash ("" for
    interpreted requests) — the join key into the plan cache and the
    coststore's per-plan summaries; `batch_id` joins against the
    micro-batcher's dispatch (defaults to the bound batch context);
    `tenant` is the QoS plane's accounting namespace ("" = untagged),
    so /debug/requests answers "whose requests were shed"."""
    rec = {"op": str(op), "trace_id": str(trace_id),
           "latency_ms": round(float(latency_ms), 3),
           "outcome": str(outcome), "node": tracing.node(),
           "plan_key": str(plan_key),
           "batch_id": str(batch_id) or _BATCH_CV.get(),
           "tenant": str(tenant),
           # wall clock: operators correlate these with external logs
           "ts": time.time()}  # dglint: disable=DG06
    if breakdown:
        rec["breakdown"] = dict(breakdown)
    with _lock:
        _recent.append(rec)
        heapq.heappush(_slow_heap,
                       (rec["latency_ms"], next(_seq), rec))
        if len(_slow_heap) > _SLOW_MAX:
            heapq.heappop(_slow_heap)  # drop the fastest
    for fn in list(_observers):
        try:
            fn(rec)
        except Exception:  # noqa: BLE001 — an alerting-plane bug  # dglint: disable=DG07 (observer runs on serving threads; no ctx owned here)
            pass  # must never kill the request that fed it


def outcome_of(exc: BaseException) -> str:
    """Classify a request-killing exception for the log (the serving
    edges share this so HTTP and gRPC report identical outcomes)."""
    from dgraph_tpu_torch.utils.reqctx import (
        Cancelled, DeadlineExceeded, Overloaded,
    )
    if isinstance(exc, Overloaded):
        return "shed"
    if isinstance(exc, DeadlineExceeded):
        return "deadline"
    if isinstance(exc, Cancelled):
        return "cancelled"
    if type(exc).__name__ == "TxnAborted":
        return "aborted"
    return "error"


def snapshot() -> dict:
    with _lock:
        slow = sorted(_slow_heap, key=lambda t: (-t[0], t[1]))
        return {"recent": list(_recent),
                "slowest": [rec for _, _, rec in slow]}


def reset() -> None:
    with _lock:
        _recent.clear()
        _slow_heap.clear()
