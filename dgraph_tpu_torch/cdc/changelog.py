"""Per-predicate bounded change logs with resumable offsets.

Offset semantics (the whole design hangs on these):

  offset(entry) = commit_ts << 16 | idx

where `idx` is the entry's position among the ops its transaction
applied to that predicate (saturating at 0xFFFF). Per tablet, commits
apply in strictly increasing ts order (the finalize-ordering machinery
in cluster/service.py exists to guarantee exactly this), so offsets are
strictly monotonic per predicate — and because every replica applies
the SAME expanded records in the SAME log order, the offset of a change
is identical on every replica of the group. A subscriber that loses its
serving node resumes on any other replica with the offset it already
holds; re-delivery of entries it has seen is possible (at-least-once),
silent gaps are not.

Logs are bounded (`cap` entries per predicate). Evicted history raises
the predicate's `floor`; a subscriber resuming below the floor gets a
typed OffsetTruncated carrying `resync_ts` — the documented re-sync
path is: read a full snapshot of the predicate at `resync_ts` (a pinned
query), then resubscribe from offset_for_ts(resync_ts). Snapshot- and
bulk-booted stores start with floor = offset_for_ts(base_ts) for the
same reason: CDC covers commits, not base state.

Backpressure is pull-side by construction: the server never buffers
per subscriber — each poll returns at most `limit` entries (clamped to
MAX_LIMIT) from the shared bounded log, and a slow subscriber's only
cost is its own lag (visible in /debug/stats and tools/dgtop.py).

Port of `dgraph_tpu/cdc/changelog.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from dgraph_tpu_torch.utils import failpoint, metrics

# ops a single transaction applies to one predicate beyond this index
# share the last offset (order preserved, duplicates indistinguishable)
_IDX_BITS = 16
_IDX_MASK = (1 << _IDX_BITS) - 1

DEFAULT_CAP = 8192        # entries retained per predicate
# raw-EdgeOp retention for the tablet-move catch-up path: shorter
# than the JSON cap on purpose — raw ops pin original Posting values
# (e.g. float-vector embeddings the JSON entries flatten), so an
# always-on full-cap raw ring would roughly double CDC memory for
# every workload to serve the rare move. A mover that falls further
# behind than this restarts from a fresh snapshot (OffsetTruncated),
# the same contract as full log eviction.
DEFAULT_RAW_CAP = 2048
MAX_LIMIT = 4096          # hard per-poll batch ceiling
DEFAULT_LIMIT = 256
MAX_WAIT_S = 60.0         # long-poll ceiling (heartbeat cadence bound)
_MAX_SUBSCRIBERS = 1024   # lag-registry bound


def offset_for_ts(ts: int) -> int:
    """The resume offset that means "everything committed AFTER ts":
    reading `after=offset_for_ts(T)` yields exactly the entries with
    commit_ts > T — the resubscribe point after a snapshot read at T."""
    return ((int(ts) + 1) << _IDX_BITS) - 1


class OffsetTruncated(Exception):
    """The requested resume offset predates the log's floor (bounded
    eviction, WAL compaction, or a snapshot-booted store). Re-sync:
    read the predicate at `resync_ts`, resubscribe from
    offset_for_ts(resync_ts)."""

    def __init__(self, pred: str, offset: int, floor: int,
                 resync_ts: Optional[int] = None):
        self.pred = pred
        self.offset = offset
        self.floor = floor
        # carried EXPLICITLY end to end: both error surfaces (HTTP 410
        # `resyncTs` and the wire `truncated` payload) ship it, and a
        # client re-raising from the wire passes it through rather
        # than re-deriving from the floor — the server's derivation is
        # the single source of truth
        self.resync_ts = (floor >> _IDX_BITS) if resync_ts is None \
            else int(resync_ts)
        super().__init__(
            f"offset {offset} for {pred!r} predates the change log "
            f"floor {floor}; re-sync: snapshot-read at ts "
            f"{self.resync_ts}, resubscribe from "
            f"offset_for_ts({self.resync_ts})")


def _jsonable(v: Any) -> Any:
    """A change entry must serialize on BOTH surfaces (HTTP JSON and
    the cluster wire), so values flatten to plain JSON types at append
    time: scalars pass through, vectors become float lists, everything
    else (datetime, geo) its canonical string form."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    try:
        import numpy as np
        if isinstance(v, np.ndarray):
            return [float(x) for x in v.tolist()]
        if isinstance(v, np.generic):
            return v.item()
    except ImportError:  # pragma: no cover
        pass
    if hasattr(v, "isoformat"):
        return v.isoformat()
    return str(v)


class _Log:
    """One predicate's bounded change list. Guarded by CdcPlane's
    lock — no locking of its own.

    `raw` holds (offset, ORIGINAL EdgeOp) pairs — not the
    JSON-flattened form: the tablet-move catch-up path replays these
    on the destination, and the JSON flattening (datetime ->
    isoformat, vectors -> float lists) is lossy — a moved tablet
    rebuilt from it would not be byte-identical. It is its own
    shorter ring (raw_floor) so its memory cost stays bounded
    independently of the JSON cap."""

    __slots__ = ("entries", "raw", "floor", "raw_floor", "head")

    def __init__(self):
        self.entries: list[dict] = []
        self.raw: list[tuple[int, Any]] = []   # (offset, EdgeOp)
        self.floor = 0   # offsets <= floor are unavailable history
        self.raw_floor = 0  # offsets <= this have no raw op anymore
        self.head = 0    # highest appended offset

    def evict_to_cap(self, cap: int, raw_cap: Optional[int] = None):
        if raw_cap is None:
            raw_cap = cap
        if len(self.entries) > cap:
            drop = len(self.entries) - cap
            self.floor = max(self.floor, self.entries[drop - 1]["offset"])
            del self.entries[:drop]
        if len(self.raw) > raw_cap:
            drop = len(self.raw) - raw_cap
            self.raw_floor = max(self.raw_floor,
                                 self.raw[drop - 1][0])
            del self.raw[:drop]
        self.raw_floor = max(self.raw_floor, self.floor)


class CdcPlane:
    """Every engine owns one (engine/db.py GraphDB.cdc): the apply
    path appends, the /subscribe surfaces read."""

    def __init__(self, cap: int = DEFAULT_CAP,
                 raw_cap: int = DEFAULT_RAW_CAP):
        self.cap = cap
        self.raw_cap = min(raw_cap, cap)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._logs: dict[str, _Log] = {}
        # sub_id -> {"pred", "offset", "seen_mono"}: the lag registry
        # dgtop's CDC panel reads; bounded, idle entries evicted first
        self._subs: dict[str, dict] = {}
        # local invalidation observer (engine/result_cache.py): called
        # OUTSIDE the lock with the set of predicates whose derived
        # state (cached query results) must drop, or None meaning
        # "everything" (drop_all). Offsets are replica-consistent by
        # construction, so every replica's observer fires on the same
        # stream — the result cache invalidates identically everywhere.
        self.on_invalidate = None

    def _fire_invalidate(self, preds) -> None:
        """`preds` = iterable of predicate names, or None for ALL.
        Never called with the plane lock held (the observer may take
        its own lock; lock order cache->cdc must not deadlock)."""
        cb = self.on_invalidate
        if cb is not None:
            cb(preds)

    # ------------------------------------------------------------ append

    def append(self, commit_ts: int, by_pred: dict[str, list]) -> None:
        """Tail one committed transaction's expanded ops. Called from
        the engine's apply path AFTER the tablet apply — the entries
        mirror exactly what the WAL framed / Raft replicated, so every
        replica derives identical offsets. An armed `cdc.append`
        failpoint error here behaves like a WAL append failure (the
        commit surfaces an error after the tablet apply)."""
        failpoint.fire("cdc.append")
        n = 0
        with self._lock:
            for pred, ops in by_pred.items():
                log = self._logs.get(pred)
                if log is None:
                    log = self._logs[pred] = _Log()
                for i, op in enumerate(ops):
                    ent: dict[str, Any] = {
                        "offset": (commit_ts << _IDX_BITS)
                        | min(i, _IDX_MASK),
                        "commitTs": commit_ts,
                        "op": op.op,
                        "uid": int(op.src),
                    }
                    if op.dst:
                        ent["dst"] = int(op.dst)
                    if op.posting is not None:
                        ent["value"] = _jsonable(op.posting.value.value)
                        if op.posting.lang:
                            ent["lang"] = op.posting.lang
                    log.entries.append(ent)
                    log.raw.append((ent["offset"], op))
                    log.head = ent["offset"]
                    n += 1
                log.evict_to_cap(self.cap, self.raw_cap)
            if n:
                self._wake.notify_all()
        if n:
            self._fire_invalidate(set(by_pred))
            metrics.inc_counter("dgraph_cdc_appended_total", n)
            with self._lock:
                total = sum(len(l.entries) for l in self._logs.values())
            metrics.set_gauge("dgraph_cdc_tail_entries", total)

    def reset_floor(self, pred: str, base_ts: int) -> None:
        """Snapshot/bulk-booted predicate: history at or below base_ts
        lives in the base state, not the log — a subscriber from an
        older offset must re-sync, never silently skip."""
        off = offset_for_ts(base_ts)
        with self._lock:
            log = self._logs.get(pred)
            if log is None:
                log = self._logs[pred] = _Log()
            if not log.entries and log.head < off:
                log.floor = max(log.floor, off)
                # the raw move-catchup ring is bounded separately but
                # obeys the same truncation contract: without this a
                # snapshot-booted source would answer read_raw below
                # the base with an empty "caught up" instead of
                # OffsetTruncated — the mover must re-snapshot
                log.raw_floor = max(log.raw_floor, off)
                log.head = max(log.head, off)
        # a floor jump IS a truncation from the cache's view: base
        # state replaced history, so results derived from the old
        # history drop wholesale — no entry below the floor may serve
        self._fire_invalidate({pred})

    def drop(self, pred: str) -> None:
        with self._lock:
            self._logs.pop(pred, None)
        self._fire_invalidate({pred})

    def clear(self) -> None:
        with self._lock:
            self._logs.clear()
            self._subs.clear()
        self._fire_invalidate(None)

    # -------------------------------------------------------------- read

    def read(self, pred: str, after: int, limit: int = DEFAULT_LIMIT,
             wait_s: float = 0.0, sub_id: str = "") -> dict:
        """Entries with offset > `after`, up to `limit`. Blocks up to
        `wait_s` for new data (long-poll); an empty result after the
        wait is a HEARTBEAT — the subscriber knows the stream is alive
        and its offset current. Raises OffsetTruncated when `after`
        predates the floor."""
        limit = max(1, min(int(limit), MAX_LIMIT))
        wait_s = max(0.0, min(float(wait_s), MAX_WAIT_S))
        failpoint.fire("cdc.deliver")
        deadline = time.monotonic() + wait_s
        with self._lock:
            while True:
                log = self._logs.get(pred)
                if log is not None and after < log.floor:
                    metrics.inc_counter("dgraph_cdc_truncated_total")
                    raise OffsetTruncated(pred, after, log.floor)
                out = []
                if log is not None and log.entries \
                        and log.head > after:
                    out = self._after(log, after, limit)
                if out or wait_s <= 0.0:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._wake.wait(remaining)
            floor = log.floor if log is not None else 0
            head = log.head if log is not None else 0
            next_off = out[-1]["offset"] if out else max(after, 0)
            if sub_id:
                self._note_subscriber(sub_id, pred, next_off)
        if out:
            metrics.inc_counter("dgraph_cdc_delivered_total", len(out))
        else:
            metrics.inc_counter("dgraph_cdc_heartbeats_total")
        return {"pred": pred, "changes": out, "nextOffset": next_off,
                "floor": floor, "head": head,
                "heartbeat": not out}

    def head(self, pred: str) -> int:
        """The predicate's highest appended offset (0 = no log). The
        fence drain compares the destination's applied watermark
        against THIS, read under the source's write lock, to prove
        nothing committed-but-unstreamed remains."""
        with self._lock:
            log = self._logs.get(pred)
            return log.head if log is not None else 0

    def read_raw(self, pred: str, after: int,
                 limit: int = DEFAULT_LIMIT) -> dict:
        """Raw EdgeOp tail for the tablet-move catch-up path: entries
        with offset > `after`, grouped [(commit_ts, [EdgeOp, ...]),
        ...] and extended past `limit` to the end of the last included
        commit — a resume point is always a commit boundary, so the
        destination's tab.max_commit_ts IS the durable progress marker
        (offset_for_ts(max_commit_ts) resumes exactly). `behind` =
        entries still unserved after this batch (the catch-up lag
        gauge). Raises OffsetTruncated when `after` predates the
        floor — the mover must re-snapshot from a newer base."""
        from bisect import bisect_right
        limit = max(1, min(int(limit), MAX_LIMIT))
        with self._lock:
            log = self._logs.get(pred)
            if log is None:
                return {"batches": [], "head": 0, "floor": 0,
                        "behind": 0}
            if after < log.raw_floor:
                metrics.inc_counter("dgraph_cdc_truncated_total")
                raise OffsetTruncated(pred, after, log.raw_floor)
            offs = [o for o, _ in log.raw]
            i = bisect_right(offs, after)
            j = min(i + limit, len(offs))
            while j < len(offs) and \
                    (offs[j] >> _IDX_BITS) == (offs[j - 1] >> _IDX_BITS):
                j += 1  # never split one commit across batches
            batches: list[tuple[int, list]] = []
            for k in range(i, j):
                ts = offs[k] >> _IDX_BITS
                if batches and batches[-1][0] == ts:
                    batches[-1][1].append(log.raw[k][1])
                else:
                    batches.append((ts, [log.raw[k][1]]))
            return {"batches": batches, "head": log.head,
                    "floor": log.raw_floor, "behind": len(offs) - j}

    @staticmethod
    def _after(log: _Log, after: int, limit: int) -> list[dict]:
        """Bisect to the first entry past `after` (entries are offset-
        sorted by construction). Returns copies — the caller serializes
        outside the lock."""
        from bisect import bisect_right
        offs = [e["offset"] for e in log.entries]
        i = bisect_right(offs, after)
        return [dict(e) for e in log.entries[i:i + limit]]

    def _note_subscriber(self, sub_id: str, pred: str, offset: int):
        """Caller holds the lock."""
        now = time.monotonic()
        if sub_id not in self._subs \
                and len(self._subs) >= _MAX_SUBSCRIBERS:
            oldest = min(self._subs, key=lambda s:
                         self._subs[s]["seen_mono"])
            del self._subs[oldest]
        self._subs[sub_id] = {"pred": pred, "offset": offset,
                              "seen_mono": now}

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        """/debug/stats "cdc" payload: per-predicate head/floor/depth
        and per-subscriber offset + lag (entries still unread) — what
        tools/dgtop.py's CDC panel renders."""
        with self._lock:
            preds = {p: {"head": l.head, "floor": l.floor,
                         "entries": len(l.entries)}
                     for p, l in self._logs.items()}
            subs = {}
            for sid, rec in self._subs.items():
                log = self._logs.get(rec["pred"])
                lag = 0
                if log is not None and log.entries:
                    from bisect import bisect_right
                    offs = [e["offset"] for e in log.entries]
                    lag = len(offs) - bisect_right(offs, rec["offset"])
                subs[sid] = {"pred": rec["pred"],
                             "offset": rec["offset"], "lag": lag}
        return {"preds": preds, "subscribers": subs}
