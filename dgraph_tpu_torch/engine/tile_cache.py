"""Residency budget for per-tablet tiles (LRU): device tiles AND
host-side columnar/compressed exports, accounted separately.

Port of `dgraph_tpu/engine/tile_cache.py`. Separate from
engine/device_cache.py so the engine can be built without touching a
device. Byte accounting duck-types:

  * np.ndarray                          -> HOST bytes
  * obj with class attr host_resident   -> HOST bytes (ValueColumns,
    TokenIndexCSR, CompressedTokenIndex, OrderPermutation,
    ops/codec.CompressedPack — explicit marker)
  * any other obj exposing .nbytes      -> DEVICE bytes (torch.Tensor)
  * dataclasses / lists / tuples        -> recurse over fields, so a
    DeviceAdjacency's numpy side-tables land in the HOST column and
    its tensors in the DEVICE column.

The device column charges the bytes the engine's device really holds.
The port's adjacency and value tiles hold int64 uids where the
reference's hold uint32, so the same adjacency charges about twice the
bytes and the same `device_hbm_budget` evicts earlier (a decided
difference of the port). A tile view that shares one flat buffer
(`ops/graph.build_adjacency`'s buckets) charges the sum of its views,
which is the buffer's size.

Ref: posting/lists.go:156 — the reference bounds posting-list memory
with an LRU; here the unit of residency is a whole tile, the device
budget is device bytes and the host budget bounds decoded/columnar
exports.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref as _weakref
from collections import OrderedDict

import numpy as np

from dgraph_tpu_torch.utils.metrics import inc_counter, set_gauge


def _tile_bytes(obj) -> tuple[int, int]:
    """(device_bytes, host_bytes) reachable through a tile structure."""
    if isinstance(obj, np.ndarray):
        return 0, int(obj.nbytes)
    if getattr(obj, "host_resident", False):
        return 0, int(getattr(obj, "nbytes", 0))
    if hasattr(obj, "nbytes") and not dataclasses.is_dataclass(obj):
        return int(obj.nbytes), 0
    if isinstance(obj, (list, tuple)):
        dev = host = 0
        for x in obj:
            d, h = _tile_bytes(x)
            dev += d
            host += h
        return dev, host
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        dev = host = 0
        for f in dataclasses.fields(obj):
            d, h = _tile_bytes(getattr(obj, f.name))
            dev += d
            host += h
        return dev, host
    return 0, 0


def _hbm_bytes(obj) -> int:
    """Device-byte view of _tile_bytes (kept for callers that only
    care about HBM)."""
    return _tile_bytes(obj)[0]


class DeviceCacheLRU:
    """Residency budget for per-tablet tiles (device + host).

    Inserting past either budget evicts the least-recently-used tiles —
    eviction drops the tablet's attribute refs so the caching allocator
    takes the buffers back once in-flight work releases them.

    A tile larger than the whole budget is still admitted alone (the
    query would otherwise never run on device); it is evicted as soon
    as anything else is admitted.
    """

    def __init__(self, budget_bytes: int,
                 host_budget_bytes: int = 512 << 20):
        self.budget = int(budget_bytes)          # HBM device bytes
        self.host_budget = int(host_budget_bytes)
        # (tablet id, attr) -> (weakref(tablet), attr, dev, host);
        # insertion order is recency order (move_to_end on touch).
        # Weak refs: tablets can also disappear through WAL replay,
        # restore, snapshot install or bulk merge (paths that never call
        # drop_tablet) — dead entries are pruned lazily so their bytes
        # never pin the budget.
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self.bytes = 0        # device bytes resident
        self.host_bytes = 0   # host export bytes resident
        self.peak_bytes = 0
        self.peak_host_bytes = 0
        self.evictions = 0
        # concurrent readers build/touch tiles (server read path runs
        # queries in parallel under an RW lock)
        self._lock = threading.Lock()

    def touch(self, tab, attr: str) -> bool:
        """Mark MRU; returns whether the entry is tracked (callers use
        this to put only on first sight)."""
        key = (id(tab), attr)
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True
            return False

    def put(self, tab, attr: str, obj) -> None:
        with self._lock:
            self._prune_dead()
            key = (id(tab), attr)
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old[2]
                self.host_bytes -= old[3]
            dev, host = _tile_bytes(obj)
            self._entries[key] = (_weakref.ref(tab), attr, dev, host)
            self.bytes += dev
            self.host_bytes += host
            self.peak_bytes = max(self.peak_bytes, self.bytes)
            self.peak_host_bytes = max(self.peak_host_bytes,
                                       self.host_bytes)
            while (self.bytes > self.budget
                   or self.host_bytes > self.host_budget) \
                    and len(self._entries) > 1:
                self._evict_lru()
        self._set_gauges()

    def _prune_dead(self):
        dead = [k for k, (ref, _, _, _) in self._entries.items()
                if ref() is None]
        for k in dead:
            _, _, dev, host = self._entries.pop(k)
            self.bytes -= dev
            self.host_bytes -= host

    def _evict_lru(self):
        _, (ref, attr, dev, host) = self._entries.popitem(last=False)
        self.bytes -= dev
        self.host_bytes -= host
        self.evictions += 1
        inc_counter("device_cache_evictions")
        tab = ref()
        if tab is None:
            return
        obj = getattr(tab, attr, None)
        if obj is not None:
            # the per-size expansion bounds of expand_np
            cache = getattr(obj, "_expander_cache", None)
            if cache:
                cache.clear()
            setattr(tab, attr, None)
            setattr(tab, attr + "_ts", -1)

    def drop_tablet(self, tab):
        """Forget every tile of a tablet (explicit drop paths; implicit
        removals are covered by the weak refs)."""
        with self._lock:
            for key in [k for k in self._entries if k[0] == id(tab)]:
                _, _, dev, host = self._entries.pop(key)
                self.bytes -= dev
                self.host_bytes -= host
        self._set_gauges()

    def _set_gauges(self):
        with self._lock:
            dev, tiles, host = (self.bytes, len(self._entries),
                                self.host_bytes)
        set_gauge("device_cache_bytes", dev)
        set_gauge("device_cache_tiles", tiles)
        set_gauge("host_tile_bytes", host)

    def stats(self) -> dict:
        with self._lock:
            self._prune_dead()
            return {"bytes": self.bytes, "tiles": len(self._entries),
                    "budget": self.budget, "evictions": self.evictions,
                    "hostBytes": self.host_bytes,
                    "hostBudget": self.host_budget,
                    "peakBytes": self.peak_bytes,
                    "peakHostBytes": self.peak_host_bytes}
