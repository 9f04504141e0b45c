"""Async cold-store prefetch: overlap tablet decode with compute.

At the 500M regime most tablets live in the cold store (group-varint
blobs behind engine/lazy_tablets.TabletStore), and a query that touches
a non-resident predicate pays the whole blob fetch + decode inline —
the decode STALL the BENCH_500M report measures. This pool moves that
decode off the query's critical path: the executor announces the
predicates a parsed query MAY touch (query/fusion.collect_preds)
before running its first block, a bounded worker pool decodes the
stored blobs concurrently, and TabletMap.get consumes the decoded
tablet when the block actually reaches the predicate — fully decoded
(hit), mid-decode (partial overlap: the caller waits out the
remainder), or never scheduled (miss, synchronous load as before).

THREAD-SAFETY CONTRACT — narrow on purpose:

  - workers only ever call TabletStore.load for predicates whose
    schema is ALREADY KNOWN (schedule() filters), so a worker never
    mutates SchemaState; the KV read is a dict probe (PyKV) or an
    immutable-snapshot read (native LSM), and restore_tablet builds a
    fresh object graph no other thread sees;
  - only the engine thread touches TabletMap; workers hand tablets
    over through Futures, and take() POPS the future so a result is
    consumed at most once;
  - staleness is settled at take(): the engine re-saved the blob
    after this future was scheduled (offload of a rolled-up overlay)
    iff the tablet's base_ts no longer matches the map's last-saved
    ts — a mismatched result is discarded, the caller loads fresh.

Decode scratch: each worker thread holds its own ops/codec
DecodeScratch, so concurrent group-varint decodes reuse buffers
without sharing them (the codec scratch is not thread-safe).

Counters (DG08-registered): prefetch_hits_total / prefetch_misses_total
/ prefetch_bytes_total and the prefetch_queue_depth gauge.

Port of `dgraph_tpu/engine/prefetch.py`. A worker restores the tablet
on the store's device (`TabletStore.device`, the engine's), its vector
index included, so a decode finished on a worker is the tablet a
synchronous load on the engine thread builds.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

from dgraph_tpu_torch.native import ClosedError
from dgraph_tpu_torch.utils.metrics import inc_counter, set_gauge

_scratch_local = threading.local()


def _worker_scratch():
    """Per-worker-thread DecodeScratch (codec scratch reuse without
    cross-thread sharing)."""
    sc = getattr(_scratch_local, "scratch", None)
    if sc is None:
        from dgraph_tpu_torch.ops.codec import DecodeScratch
        sc = DecodeScratch()
        _scratch_local.scratch = sc
    return sc


class PrefetchPool:
    """Bounded tablet-decode pool in front of a TabletStore."""

    def __init__(self, store, workers: int = 2, max_inflight: int = 8):
        self.store = store
        self.max_inflight = max(1, max_inflight)
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, workers),
            thread_name_prefix="dg-prefetch")
        self._lock = threading.Lock()
        self._inflight: dict[str, Future] = {}
        self.hits = 0
        self.misses = 0
        self.bytes = 0
        self.scheduled = 0
        self.waits = 0
        self._closed = False

    # ------------------------------------------------------------ engine

    def schedule(self, db, preds) -> int:
        """Queue decodes for every predicate in `preds` that is
        stored, not resident, schema-known and not already in flight.
        Bounded by max_inflight; excess predicates simply load
        synchronously later (no queue growth under fan-out). Returns
        the number newly scheduled."""
        with self._lock:
            if self._closed:
                return 0
        tablets = db.tablets
        stored = getattr(tablets, "stored", None)
        if not stored:
            return 0
        n = 0
        with self._lock:
            for pred in preds:
                if len(self._inflight) >= self.max_inflight:
                    break
                if pred in self._inflight or pred not in stored:
                    continue
                if dict.get(tablets, pred) is not None:
                    continue  # resident: no store access coming
                if not db.schema.has(pred):
                    # a worker must never mutate SchemaState
                    continue
                self._inflight[pred] = self._pool.submit(
                    self._decode, pred, db.schema)
                n += 1
            self.scheduled += n
            set_gauge("prefetch_queue_depth", len(self._inflight))
        return n

    def take(self, pred: str, saved_ts: Optional[int]):
        """Consume the prefetched tablet for `pred`, or None. Pops the
        future (at-most-once handover); waits out an in-flight decode
        (the overlap already banked is kept). `saved_ts` is the
        engine's last-saved base_ts for the predicate — a decode of a
        blob the engine has re-saved since scheduling is stale and
        discarded."""
        with self._lock:
            fut = self._inflight.pop(pred, None)
            set_gauge("prefetch_queue_depth", len(self._inflight))
        if fut is None:
            return None
        if not fut.done():
            with self._lock:
                self.waits += 1
        try:
            tab, nbytes = fut.result()
        except Exception:
            return None
        if tab is None:
            return None
        if saved_ts is not None and tab.base_ts != saved_ts:
            return None  # blob re-saved after scheduling: stale decode
        with self._lock:
            self.hits += 1
            self.bytes += nbytes
        inc_counter("prefetch_hits_total")
        inc_counter("prefetch_bytes_total", nbytes)
        return tab

    def miss(self) -> None:
        """A synchronous store load happened with no prefetched result
        (TabletMap.get calls this when the pool is attached)."""
        with self._lock:
            self.misses += 1
        inc_counter("prefetch_misses_total")

    def stats(self) -> dict:
        with self._lock:
            return {"workers": self._pool._max_workers,
                    "inflight": len(self._inflight),
                    "scheduled": self.scheduled,
                    "hits": self.hits, "misses": self.misses,
                    "waits": self.waits, "bytes": self.bytes}

    def close(self) -> None:
        """Cancel the queued decodes, then wait for the running ones,
        so that the store outlives every read of it (GraphDB.close
        closes the store right after). The wait holds no lock: a decode
        takes only the store's handle and builds a fresh tablet, so a
        caller may close from any thread that holds no store call
        open."""
        with self._lock:
            self._closed = True
            self._inflight.clear()
            set_gauge("prefetch_queue_depth", 0)
        self._pool.shutdown(wait=True, cancel_futures=True)

    # ------------------------------------------------------------ worker

    def _decode(self, pred: str, schema_state):
        """Worker: KV read + group-varint decode into a fresh Tablet.
        Runs entirely off the engine thread; schema_state is read-only
        here (schedule() guaranteed the predicate is known)."""
        from dgraph_tpu_torch import wire
        from dgraph_tpu_torch.storage.snapshot import restore_tablet

        _worker_scratch()  # pin per-thread codec scratch
        try:
            blob = self.store.kv.get(b"tab:" + pred.encode("utf-8"))
        except ClosedError:
            # the store closed first (close drains the pool, so only a
            # store closed behind the engine's back): nothing loaded
            return None, 0
        if blob is None:
            return None, 0
        payload = wire.loads(blob)
        tab = restore_tablet(pred, schema_state.get_or_default(pred),
                             payload["tablet"], self.store.device)
        return tab, len(blob)
