"""Server-side query micro-batching: same-plan requests coalesce.

Under a high-concurrency request mix, many in-flight queries share one
compiled plan (query/plan.py skeleton) — often they are literally the
same query. Dispatching each on its own thread pays per-request lock
acquisition, snapshot pinning and (on the device tier) a separate
dispatch per stage. The MicroBatcher holds the FIRST arrival of a plan
key for a short window (`--batch-window-us`); every request with the
same key that arrives inside the window joins the batch, and the
leader dispatches the whole batch as one unit:

  - ONE read-lock acquisition and ONE MVCC snapshot (read_ts) for the
    batch, so every member answers at the same timestamp — exactly
    what each would have seen dispatched alone at that moment;
  - requests with identical (text, variables) single-flight: the
    query executes once and the response string fans out byte-for-byte
    identical to every member;
  - distinct parameter bindings of the same skeleton execute back to
    back on the leader's thread through the shared warm plan (no
    retrace, no re-parse), then de-multiplex to their waiters.

Deadlines stay per-request: the wait is bounded by each member's
propagated deadline (utils/reqctx) — a member that expires while
queued gets its DeadlineExceeded (HTTP 408) without poisoning the
batch, and a member whose context dies mid-execution surrenders the
execution to the next live member instead of failing the group.

Correctness boundaries: only txn-free, snapshot-unpinned reads are
eligible (the serving layer routes everything else straight to the
engine); mutations never batch. Strict and best-effort reads batch
SEPARATELY: a strict batch allocates one fresh coordinator timestamp
(the same source an unbatched strict read uses), a best-effort batch
reads at the watermark — batching never downgrades a read's
snapshot source.

Port of `dgraph_tpu/engine/batcher.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import nullcontext
from typing import Any, Callable, Optional

from dgraph_tpu_torch.utils import metrics, reqlog
from dgraph_tpu_torch.utils.reqctx import DeadlineExceeded, RequestAborted
from dgraph_tpu_torch.utils.tracing import span as _span

# process-wide batch-dispatch ids: reqlog records made inside a
# dispatch carry `batch_id` so /debug/requests joins against the
# micro-batcher (which members shared a dispatch, what it cost each)
_BATCH_SEQ = itertools.count(1)


class _Member:
    __slots__ = ("q", "variables", "ctx", "idkey", "event", "result",
                 "error", "best_effort")

    def __init__(self, q, variables, ctx, idkey, best_effort=True):
        self.q = q
        self.variables = variables
        self.ctx = ctx
        self.idkey = idkey
        self.event = threading.Event()
        self.result: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.best_effort = best_effort


class _Batch:
    __slots__ = ("members", "ready", "closed")

    def __init__(self):
        self.members: list[_Member] = []
        self.ready = threading.Event()  # cut the window short
        self.closed = False


class MicroBatcher:
    """Coalesces concurrent `query_json` calls by plan-cache key.

    `read_lock` is a zero-arg callable returning a context manager
    (the serving layer passes its reader lock); the leader holds it
    once around the whole batch dispatch.
    """

    def __init__(self, db, window_us: int = 250, max_batch: int = 64,
                 read_lock: Optional[Callable[[], Any]] = None):
        self.db = db
        self.window_s = max(0, int(window_us)) / 1e6
        self.max_batch = max(1, int(max_batch))
        self.read_lock = read_lock
        self._lock = threading.Lock()
        self._open: dict[Any, _Batch] = {}

    # -- keys ----------------------------------------------------------

    def _keys(self, q: str, variables: Optional[dict]) -> tuple:
        """(group key, identity key): group = the plan-cache identity
        (skeleton + schema epoch — requests whose plans hash to the
        same cache entry coalesce), identity = exact (text, bound
        variables) for single-flighting."""
        from dgraph_tpu_torch.query.plan import _var_key

        idkey = (q, _var_key(variables))
        pc = getattr(self.db, "plan_cache", None)
        if pc is not None:
            try:
                _parsed, _struct, skel = pc.parse(q, variables)
                return (skel, self.db.schema_epoch), idkey
            except Exception:
                pass  # parse errors take the solo path and raise there
        return idkey, idkey

    # -- entry ---------------------------------------------------------

    def query_json(self, q: str, variables: Optional[dict] = None, *,
                   ctx=None, best_effort: bool = True) -> str:
        if self.window_s <= 0:
            return self._solo(q, variables, ctx, best_effort)
        gk, idkey = self._keys(q, variables)
        # strict and best-effort reads never share a batch: their
        # snapshots come from different sources (see _dispatch)
        gk = (gk, best_effort)
        m = _Member(q, variables, ctx, idkey, best_effort)
        with self._lock:
            b = self._open.get(gk)
            if b is None or b.closed:
                b = _Batch()
                b.members.append(m)
                self._open[gk] = b
                leader = True
            else:
                b.members.append(m)
                if len(b.members) >= self.max_batch:
                    b.ready.set()
                leader = False
        if leader:
            return self._lead(gk, b, m)
        # a follower with less headroom than the window forces an
        # immediate dispatch rather than burning its budget queued
        if ctx is not None:
            rem = ctx.remaining()
            if rem is not None and rem < 2 * self.window_s:
                b.ready.set()
        return self._wait(b, m)

    # -- leader --------------------------------------------------------

    def _lead(self, gk, b: _Batch, me: _Member) -> str:
        with _span("batch.wait", role="leader"):
            deadline = time.monotonic() + self.window_s
            if me.ctx is not None:
                rem = me.ctx.remaining()
                if rem is not None:
                    deadline = min(deadline,
                                   time.monotonic() + rem / 2)
            while not b.ready.is_set():
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                b.ready.wait(left)
        with self._lock:
            b.closed = True
            if self._open.get(gk) is b:
                del self._open[gk]
            members = list(b.members)
        self._dispatch(members)
        if me.error is not None:
            raise me.error
        return me.result  # type: ignore[return-value]

    def _dispatch(self, members: list[_Member]):
        metrics.inc_counter("batch_dispatches")
        metrics.observe("batch_occupancy", float(len(members)))
        batch_id = f"b{next(_BATCH_SEQ):06x}"
        # members that died while queued answer 408/499 immediately
        # and drop out; the batch itself is unaffected
        live: dict[tuple, list[_Member]] = {}
        for m in members:
            if m.ctx is not None:
                try:
                    m.ctx.check("batch.dequeue")
                except RequestAborted as e:
                    m.error = e
                    m.event.set()
                    continue
            live.setdefault(m.idkey, []).append(m)
        lock_cm = self.read_lock() if self.read_lock is not None \
            else nullcontext()
        try:
            with lock_cm, reqlog.bind_batch(batch_id):
                # one snapshot for the whole batch, from the same
                # source an unbatched dispatch would use NOW: strict
                # batches allocate ONE fresh ts at the coordinator
                # (the authoritative clock — a lagging local watermark
                # must not silently downgrade a linearizable read),
                # best-effort batches read the watermark
                strict = any(not m.best_effort for m in members)
                read_ts = self.db.coordinator.next_ts() if strict \
                    else self.db.coordinator.max_assigned()
                for group in live.values():
                    self._run_group(group, read_ts)
        except BaseException as e:
            for m in members:
                if m.result is None and m.error is None:
                    m.error = e if isinstance(e, Exception) \
                        else RuntimeError(f"batch dispatch died: {e!r}")
            raise
        finally:
            # waiters unblock no matter how dispatch exits
            for m in members:
                m.event.set()

    def _run_group(self, group: list[_Member], read_ts: int):
        """Execute one distinct (text, variables) binding and fan the
        response out. If the executing member's context aborts
        mid-flight, the next live member re-drives the execution —
        one member's deadline never fails its co-batched peers."""
        remaining = list(group)
        while remaining:
            driver = remaining[0]
            try:
                out = self.db.query_json(
                    driver.q, driver.variables, read_ts=read_ts,
                    ctx=driver.ctx)
            except RequestAborted as e:
                driver.error = e
                remaining.pop(0)
                continue
            except Exception as e:
                # deterministic query error: identical for every
                # member of the group
                for m in remaining:
                    m.error = e
                return
            for m in remaining:
                m.result = out
            return

    # -- follower ------------------------------------------------------

    def _wait(self, b: _Batch, m: _Member) -> str:
        with _span("batch.wait", role="member"):
            timeout = None
            if m.ctx is not None:
                timeout = m.ctx.remaining()
            if not m.event.wait(timeout):
                # expired while queued: the leader will mark this
                # member aborted at dequeue (or its result arrives to
                # nobody); either way the client gets its 408 now
                raise DeadlineExceeded(
                    "deadline expired while queued in batch")
            if m.error is not None:
                raise m.error
            if m.result is None:  # defensive: should not happen
                raise RuntimeError("batch member finished without "
                                   "result or error")
            return m.result

    # -- passthrough ---------------------------------------------------

    def _solo(self, q, variables, ctx, best_effort: bool = True) -> str:
        lock_cm = self.read_lock() if self.read_lock is not None \
            else nullcontext()
        with lock_cm:
            return self.db.query_json(q, variables, ctx=ctx,
                                      best_effort=best_effort)
