"""CDC-invalidated query result cache (the read scale-out tier).

A bounded LRU over FULLY SERIALIZED query responses, keyed on the
compiled-plan skeleton the plan cache already derives:

    (payload kind, skeleton hash, structure, params,
     read_ts-class, schema epoch)

Two read_ts-classes exist. `("ts", T)` — a read pinned to an explicit
timestamp (the follower-read path: RoutedCluster grants one zero ts
per ~50 ms window, so every replica sees the same T across many
requests) — is immutable by MVCC: the snapshot at T never changes, so
a hit is sound forever and invalidation only manages memory. `("be",)`
— a best-effort read at the node's own applied watermark — is the
class CDC invalidation keeps honest: every entry records its
predicate footprint (query_predicates over the parsed query), and
the local change log's observer hook
(cdc/changelog.CdcPlane.on_invalidate) drops every entry touching a
written predicate the moment the commit lands. Offsets — and
therefore the invalidation stream — are replica-consistent by
construction, so every replica of a group invalidates
identically: a cached byte anywhere is a byte the engine would
produce fresh.

Truncation events (snapshot/bulk boot raising a predicate's floor,
tablet import, drop) fire the same hook: the affected predicates'
entries drop WHOLESALE — a cache must never outlive the history it
was derived from. drop_all clears everything (preds=None).

Bypass rules live in GraphDB._result_cache_probe: txn reads, strict
reads, explain requests, schema introspection, expand() blocks
(footprint unknowable from the skeleton) and unhashable params all
skip the cache entirely.

Port of `dgraph_tpu/engine/result_cache.py`. The footprint comes from
`query_predicates` below, the port's copy of the reference's
`server/acl.query_predicates` and `block_predicates`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Iterable, Optional

from dgraph_tpu_torch.utils import metrics


class ResultCache:
    """Bounded LRU of (key -> serialized response, predicate
    footprint) with a per-predicate reverse index for O(touched)
    invalidation. One lock; every operation is dict work — far off
    the execution path it short-circuits."""

    def __init__(self, entries: int = 4096):
        self.entries = max(1, int(entries))
        self._lock = threading.Lock()
        # key -> (value, footprint tuple); insertion order is the LRU
        self._lru: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._by_pred: dict[str, set] = {}
        # bumped on EVERY invalidation event: the fill-race guard —
        # a result computed before a commit and stored after its
        # invalidation sweep would be a stale entry the sweep can
        # never reach (see put(gen=...))
        self._gen = 0

    # ------------------------------------------------------------ serve

    def get(self, key: tuple) -> Optional[Any]:
        with self._lock:
            got = self._lru.get(key)
            if got is None:
                metrics.inc_counter("dgraph_result_cache_misses_total")
                return None
            self._lru.move_to_end(key)
            metrics.inc_counter("dgraph_result_cache_hits_total")
            return got[0]

    @property
    def generation(self) -> int:
        with self._lock:
            return self._gen

    def put(self, key: tuple, preds: Iterable[str], value: Any,
            gen: Optional[int] = None) -> None:
        """Store a fill. With `gen` (a generation captured BEFORE the
        result was computed), the fill is discarded when any
        invalidation landed in between — the coarse but sound guard
        against caching a snapshot older than a swept commit."""
        footprint = tuple(sorted(set(preds)))
        with self._lock:
            if gen is not None and gen != self._gen:
                return  # an invalidation raced this fill: drop it
            if key in self._lru:
                self._lru.move_to_end(key)  # racer already stored it
                return
            self._lru[key] = (value, footprint)
            for p in footprint:
                self._by_pred.setdefault(p, set()).add(key)
            while len(self._lru) > self.entries:
                old_key, (_, old_fp) = self._lru.popitem(last=False)
                self._unindex(old_key, old_fp)
            size = len(self._lru)
        metrics.set_gauge("dgraph_result_cache_entries", size)

    # ------------------------------------------------------ invalidate

    def invalidate(self, preds: Optional[Iterable[str]] = None) -> int:
        """CdcPlane.on_invalidate target: drop every entry whose
        footprint touches `preds` (None = drop everything). Returns
        the number of entries dropped. Reverse predicates invalidate
        through their base name — footprints and change-log keys both
        carry the base predicate."""
        dropped = 0
        with self._lock:
            self._gen += 1
            if preds is None:
                dropped = len(self._lru)
                self._lru.clear()
                self._by_pred.clear()
            else:
                doomed: set = set()
                for p in preds:
                    doomed |= self._by_pred.get(p, set())
                for key in doomed:
                    got = self._lru.pop(key, None)
                    if got is not None:
                        self._unindex(key, got[1])
                        dropped += 1
            size = len(self._lru)
        if dropped:
            metrics.inc_counter(
                "dgraph_result_cache_invalidations_total", dropped)
        metrics.set_gauge("dgraph_result_cache_entries", size)
        return dropped

    def _unindex(self, key: tuple, footprint: tuple) -> None:
        """Caller holds the lock."""
        for p in footprint:
            bucket = self._by_pred.get(p)
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._by_pred[p]

    # ------------------------------------------------------------ stats

    def stats(self) -> dict:
        """/debug/stats "resultCache" payload (dgtop SERVING panel)."""
        with self._lock:
            size = len(self._lru)
            preds = len(self._by_pred)
        hits = metrics.get_counter("dgraph_result_cache_hits_total")
        misses = metrics.get_counter("dgraph_result_cache_misses_total")
        total = hits + misses
        return {"entries": size, "capacity": self.entries,
                "preds": preds, "hits": hits, "misses": misses,
                "hitRate": (hits / total) if total else 0.0,
                "invalidations": metrics.get_counter(
                    "dgraph_result_cache_invalidations_total")}


# ---------------------------------------------------------- footprint


def block_predicates(gq) -> set[str]:
    """Predicates ONE query block touches (its func, filters, order,
    groupby and children, recursively)."""
    preds: set[str] = set()

    def walk_filter(ft):
        if ft is None:
            return
        if ft.func is not None and ft.func.attr:
            preds.add(ft.func.attr)
        for ch in ft.children:
            walk_filter(ch)

    def walk(g):
        if g.attr and not g.is_internal:
            preds.add(g.attr)
        if g.func is not None and g.func.attr:
            preds.add(g.func.attr)
        walk_filter(g.filter)
        for o in g.order:
            preds.add(o.attr)
        for gb in g.groupby:
            preds.add(gb.attr)
        for ch in g.children:
            walk(ch)

    walk(gq)
    preds.discard("uid")
    return {p for p in preds if p}


def query_predicates(parsed) -> list[str]:
    """All predicates a parsed query touches (blocks, children, funcs,
    filters, order) — the reference's parsePredsFromQuery
    (access_ee.go:670 area)."""
    preds: set[str] = set()
    for gq in parsed.queries:
        preds |= block_predicates(gq)
    return sorted(preds)
