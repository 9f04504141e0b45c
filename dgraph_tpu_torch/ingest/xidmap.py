"""xid → uid assignment with lease blocks.

Re-provides xidmap/xidmap.go:39: external ids (blank nodes, client ids)
map to leased uids; shards keyed by fingerprint reduce lock contention;
optional JSON persistence replaces the reference's Badger backing.

Port of `dgraph_tpu/ingest/xidmap.py`: a copy, its imports pointed
at this package.
"""

from __future__ import annotations

import json
import os
import threading
import zlib

from dgraph_tpu_torch.cluster.coordinator import Coordinator

NUM_SHARDS = 32        # ref xidmap numShards
LEASE_BLOCK = 10_000   # uids leased per refill (ref xidmap.go block size)


class XidMap:
    def __init__(self, coordinator: Coordinator,
                 persist_path: str | None = None):
        self.coordinator = coordinator
        self.persist_path = persist_path
        self._shards = [dict() for _ in range(NUM_SHARDS)]
        self._locks = [threading.Lock() for _ in range(NUM_SHARDS)]
        self._lease_lock = threading.Lock()
        self._next = 0
        self._last = -1  # empty lease
        if persist_path and os.path.exists(persist_path):
            with open(persist_path) as f:
                loaded = json.load(f)
            for xid, uid in loaded.items():
                self._shards[self._shard(xid)][xid] = uid
                coordinator.bump_uids(uid)

    @staticmethod
    def _shard(xid: str) -> int:
        return zlib.crc32(xid.encode()) % NUM_SHARDS

    def _alloc(self) -> int:
        with self._lease_lock:
            if self._next > self._last:
                self._next, self._last = \
                    self.coordinator.assign_uids(LEASE_BLOCK)
            uid = self._next
            self._next += 1
            return uid

    def assign(self, xid: str) -> int:
        """uid for xid, allocating on first sight
        (ref xidmap.AssignUid, xidmap/xidmap.go:152)."""
        s = self._shard(xid)
        with self._locks[s]:
            uid = self._shards[s].get(xid)
            if uid is None:
                uid = self._alloc()
                self._shards[s][xid] = uid
            return uid

    def lookup(self, xid: str) -> int | None:
        s = self._shard(xid)
        with self._locks[s]:
            return self._shards[s].get(xid)

    def bump_to(self, uid: int):
        """Ensure future allocations exceed `uid`
        (ref xidmap.BumpTo, xidmap/xidmap.go:200)."""
        self.coordinator.bump_uids(uid)
        with self._lease_lock:
            self._next, self._last = 0, -1  # force fresh lease

    def flush(self):
        if not self.persist_path:
            return
        merged = {}
        for s in self._shards:
            merged.update(s)
        tmp = self.persist_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f)
        os.replace(tmp, self.persist_path)

    def __len__(self):
        return sum(len(s) for s in self._shards)
