"""Coordinator: timestamps, UID leases, transaction oracle, tablet map.

Re-provides Dgraph Zero's core services (dgraph/cmd/zero/):
  - monotonically increasing timestamps     (zero/assign.go:64 lease)
  - UID block leases                        (zero/assign.go:158 AssignUids)
  - commit/abort with conflict detection    (zero/oracle.go:326 commit,
                                             oracle.go:76 hasConflict)
  - tablet -> group ownership               (zero/zero.go:564 ShouldServe)

Design difference from the reference: Zero is a separate Raft-replicated
process streaming OracleDeltas to every Alpha group
(zero/oracle.go:432). Here the coordinator is a small passive object the
engine calls synchronously; the cluster layer wraps it in a DCN service
and Raft once multi-host lands. The conflict-detection semantics are
identical: a txn T aborts iff some key it wrote was committed by another
txn with commitTs > T.startTs.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


class TxnAborted(Exception):
    """Transaction aborted due to conflict (ref x.ErrConflict /
    pb.TxnContext.Aborted)."""


class StaleSnapshot(TxnAborted):
    """A pinned read's timestamp fell below a tablet's rollup
    watermark: commits newer than the read ts were already folded into
    base state, so the exact snapshot no longer exists.  Retryable —
    re-issue the read at a fresh timestamp (subclassing TxnAborted
    rides the existing retry/ABORTED mappings on every transport)."""


@dataclass
class TxnState:
    start_ts: int
    conflict_keys: set = field(default_factory=set)
    committed: bool = False
    aborted: bool = False


class Coordinator:
    def __init__(self):
        self._lock = threading.Lock()
        self._ts = 0              # last issued timestamp
        self._next_uid = 1
        # conflict window: key fingerprint -> last commit_ts
        self._commits: dict[int, int] = {}
        self._active: dict[int, TxnState] = {}
        self._min_active: int = 0
        # pinned snapshot reads: ts -> [refcount, monotonic expiry].
        # Holds the rollup watermark at/below the ts of any in-flight
        # read — folding a commit ABOVE a reader's ts fuses it into
        # base state the reader cannot exclude (the split-bank
        # invariant broke exactly this way). The TTL reaps pins leaked
        # by a crashed reader.
        self._pinned: dict[int, list] = {}
        # tablet map: predicate -> group id (single group 1 in round 1)
        self.tablets: dict[str, int] = {}
        self.groups: set[int] = {1}

    # -- timestamps (ref zero/assign.go:64) --

    # when set, timestamps come from the cluster's Zero quorum (one
    # allocation RPC each, like the reference's zero AssignTimestampIds)
    # so every group's ts live in ONE global order and cross-group
    # snapshot reads are comparable. fn(n) -> first ts of a block of n.
    ts_source_fn = None

    def _alloc_ts(self) -> int:
        if self.ts_source_fn is not None:
            ts = self.ts_source_fn(1)
            self._ts = max(self._ts, ts)
            return ts
        self._ts += 1
        return self._ts

    def next_ts(self) -> int:
        with self._lock:
            return self._alloc_ts()

    def max_assigned(self) -> int:
        with self._lock:
            return self._ts

    def observe_ts(self, ts: int):
        """Advance the local high-water mark past a ts somebody else
        allocated (replay/replication) WITHOUT allocating — with a zero
        ts source, allocation is an RPC and must never run in a
        catch-up loop."""
        with self._lock:
            self._ts = max(self._ts, ts)

    # -- uid leases (ref zero/assign.go:158) --

    # when set, uid blocks come from the cluster's Zero quorum instead
    # of the local counter, so every group allocates from ONE disjoint
    # space (without this, two groups both start at uid 1 and a tablet
    # move would merge unrelated entities). fn(n) -> first uid.
    uid_lease_fn = None
    UID_LEASE_BLOCK = 10_000

    def assign_uids(self, n: int) -> tuple[int, int]:
        """Lease [first, last] inclusive."""
        with self._lock:
            if self.uid_lease_fn is not None:
                end = getattr(self, "_lease_end", 0)
                if self._next_uid + n - 1 > end:
                    block = max(n, self.UID_LEASE_BLOCK)
                    first = self.uid_lease_fn(block)
                    self._next_uid = first
                    self._lease_end = first + block - 1
            first = self._next_uid
            self._next_uid += n
            return first, self._next_uid - 1

    def bump_uids(self, to: int):
        with self._lock:
            self._next_uid = max(self._next_uid, to + 1)

    # -- transactions (ref zero/oracle.go) --

    def begin(self) -> TxnState:
        with self._lock:
            st = TxnState(start_ts=self._alloc_ts())
            self._active[st.start_ts] = st
            return st

    def begin_at(self, start_ts: int) -> TxnState:
        """Register a txn at a previously issued read timestamp — the
        stateless-HTTP flow where a query hands out startTs and a later
        /mutate attaches to it (ref posting.Oracle RegisterStartTs)."""
        with self._lock:
            if start_ts <= 0 or start_ts > self._ts:
                raise ValueError(f"unknown startTs {start_ts}")
            if start_ts in self._active:
                raise ValueError(f"startTs {start_ts} already in use")
            st = TxnState(start_ts=start_ts)
            self._active[start_ts] = st
            return st

    # when set, commit decisions come from the cluster's Zero quorum
    # (fn(start_ts, sorted_keys) -> commit_ts, 0 = conflict abort) so
    # EVERY group's transactions share one global conflict oracle —
    # exactly the reference, where all commits flow through Zero
    # (zero/oracle.go:326). The decision is mirrored into the local
    # window so replica-side checks stay consistent.
    commit_source_fn = None

    def commit(self, txn: TxnState, conflict_keys: set) -> int:
        """Conflict-check and commit; returns commit_ts.
        Raises TxnAborted on conflict (ref zero/oracle.go:326 s.commit)."""
        with self._lock:
            st = self._active.get(txn.start_ts)
            if st is None or st.aborted:
                raise TxnAborted(f"txn {txn.start_ts} not active")
            if self.commit_source_fn is not None:
                commit_ts = self.commit_source_fn(
                    txn.start_ts, sorted(int(k) for k in conflict_keys))
                del self._active[txn.start_ts]
                if not commit_ts:
                    st.aborted = True
                    raise TxnAborted(
                        f"zero oracle aborted txn {txn.start_ts} "
                        "(write-write conflict)")
                self._ts = max(self._ts, commit_ts)
                for key in conflict_keys:
                    if commit_ts > self._commits.get(key, 0):
                        self._commits[key] = commit_ts
                st.committed = True
                return commit_ts
            for key in conflict_keys:
                last = self._commits.get(key, 0)
                if last > txn.start_ts:
                    st.aborted = True
                    del self._active[txn.start_ts]
                    raise TxnAborted(
                        f"conflict on key {key:#x}: committed at {last} > "
                        f"start {txn.start_ts}")
            commit_ts = self._alloc_ts()
            for key in conflict_keys:
                self._commits[key] = commit_ts
            st.committed = True
            del self._active[txn.start_ts]
            return commit_ts

    def register_commit(self, conflict_keys: set, commit_ts: int):
        """Mirror an externally decided commit into the conflict window
        (ref posting/oracle.go:207 ProcessDelta: every alpha replays
        Zero's commit decisions into its local oracle). Used by the
        Raft apply path so a deposed-then-re-elected leader's conflict
        checks see writes that committed through another leader."""
        with self._lock:
            self._ts = max(self._ts, commit_ts)
            for key in conflict_keys:
                if commit_ts > self._commits.get(key, 0):
                    self._commits[key] = commit_ts

    def abort(self, txn: TxnState):
        with self._lock:
            st = self._active.pop(txn.start_ts, None)
            if st:
                st.aborted = True

    def pin_read(self, ts: int, ttl_s: float = 60.0):
        """Register an in-flight pinned snapshot read at `ts` (see
        _pinned). Always pair with unpin_read."""
        with self._lock:
            ent = self._pinned.get(ts)
            exp = time.monotonic() + ttl_s
            if ent is not None:
                ent[0] += 1
                ent[1] = max(ent[1], exp)
            else:
                self._pinned[ts] = [1, exp]

    def unpin_read(self, ts: int):
        with self._lock:
            ent = self._pinned.get(ts)
            if ent is not None:
                ent[0] -= 1
                if ent[0] <= 0:
                    del self._pinned[ts]

    def min_active_ts(self) -> int:
        """Rollup watermark: everything <= this is safe to fold
        (ref worker/draft.go:1206 calculateSnapshot picking a ReadTs
        below all pending txns). Pinned snapshot reads hold it too —
        folding UP TO a pinned ts is safe (the reader sees base +
        overlay <= its ts), past it is not."""
        with self._lock:
            wm = min(self._active) - 1 if self._active else self._ts
            if self._pinned:
                now = time.monotonic()
                dead = [t for t, ent in self._pinned.items()
                        if ent[1] < now]
                for t in dead:
                    del self._pinned[t]
                if self._pinned:
                    wm = min(wm, min(self._pinned))
            return wm

    def gc_conflicts(self):
        """Drop conflict entries older than every active txn."""
        with self._lock:
            floor = min(self._active) if self._active else self._ts
            self._commits = {k: v for k, v in self._commits.items()
                             if v >= floor}

    # -- tablet ownership (ref zero/zero.go:564 ShouldServe) --

    def should_serve(self, pred: str, group: int = 1) -> int:
        with self._lock:
            gid = self.tablets.get(pred)
            if gid is None:
                gid = group
                self.tablets[pred] = gid
            return gid
