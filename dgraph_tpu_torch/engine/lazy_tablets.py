"""Store-backed tablets: the engine serves datasets larger than RAM.

The reference's posting lists materialize lazily from Badger and evict
under memory pressure (posting/mvcc.go:143 ReadPostingList against
disk, posting/lists.go LRU); without a store, every tablet stays
resident in RAM. With GraphDB(store_dir=...), tablet base state lives
in the host runtime's LSM store (csrc/native.cc: memtable + immutable
sorted runs) as one wire blob per predicate:

  - a Tablet materializes on first access (TabletMap.get) and counts
    against a resident-bytes budget;
  - CLEAN tablets evict LRU-first once the budget overflows, writing
    their blob back only when changed (base_ts advanced);
  - DIRTY tablets (live overlay deltas) never evict — rollup folds
    them first, exactly the device-tile residency rule;
  - the bulk loader offloads each predicate as its reduce finishes, so
    peak residency during a load is one predicate, not the dataset.

TabletMap iteration — keys, values and items — covers every KNOWN
predicate: values/items LAZILY materialize stored tablets one at a
time (each load enters the LRU and can evict the previous one), so
whole-store walks like backup, snapshot dump and `S * *` delete
expansion stay correct AND memory-bounded.

Port of `dgraph_tpu/engine/lazy_tablets.py`. As in the reference, the
store is `native.NativeKV`, and `storage/kvfallback.PyKV` (RAM-bound: a
dict and a WAL) when the runtime is switched off; either package opens
the other's store of the same kind. A store materializes its tablets,
their vector indexes included, on the engine's device
(`TabletStore(directory, device)`); an offload drops the tablet's tiles
from the engine's tile budget, and a reloaded tablet builds them
afresh.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from dgraph_tpu_torch import wire
from dgraph_tpu_torch.utils.metrics import inc_counter

_TAB_PREFIX = b"tab:"
_SCHEMA_KEY = b"meta:schema"
_MAXTS_KEY = b"meta:max_ts"


class TabletStore:
    """One wire blob per predicate in the native LSM KV (PyKV when the
    runtime is switched off — correctness-identical, RAM-bound);
    tablets load onto `device` (None: the card)."""

    def __init__(self, directory: str, device=None):
        from dgraph_tpu_torch import native
        from dgraph_tpu_torch.backend import resolve_device
        self.device = resolve_device(device)
        if native.available():
            self.kv = native.NativeKV(directory)
        else:
            from dgraph_tpu_torch.storage.kvfallback import PyKV
            self.kv = PyKV(directory)

    def preds(self) -> list[str]:
        out = []
        for k, _v in self.kv.scan(_TAB_PREFIX):
            out.append(k[len(_TAB_PREFIX):].decode("utf-8"))
        return out

    def save(self, tab) -> None:
        from dgraph_tpu_torch.storage.snapshot import dump_tablet
        blob = wire.dumps({"schema": tab.schema.describe(),
                           "tablet": dump_tablet(tab)})
        self.kv.put(_TAB_PREFIX + tab.pred.encode("utf-8"), blob)

    def load(self, pred: str, schema_state):
        from dgraph_tpu_torch.storage.snapshot import restore_tablet
        blob = self.kv.get(_TAB_PREFIX + pred.encode("utf-8"))
        if blob is None:
            return None
        payload = wire.loads(blob)
        if not schema_state.has(pred):
            schema_state.apply_text(payload["schema"])
        return restore_tablet(pred, schema_state.get_or_default(pred),
                              payload["tablet"], self.device)

    def delete(self, pred: str) -> None:
        self.kv.delete(_TAB_PREFIX + pred.encode("utf-8"))

    def save_schema(self, text: str) -> None:
        self.kv.put(_SCHEMA_KEY, text.encode("utf-8"))

    def save_max_ts(self, ts: int) -> None:
        self.kv.put(_MAXTS_KEY, str(int(ts)).encode())

    def load_max_ts(self) -> int:
        blob = self.kv.get(_MAXTS_KEY)
        return int(blob) if blob else 0

    def load_schema(self) -> str:
        blob = self.kv.get(_SCHEMA_KEY)
        return blob.decode("utf-8") if blob else ""

    def compact(self) -> None:
        if hasattr(self.kv, "snapshot"):
            self.kv.snapshot()

    def close(self) -> None:
        self.kv.close()


class TabletMap(dict):
    """dict of resident tablets + lazy materialization from the store.

    The executor and engine only ever look tablets up via .get()/[] —
    both load on miss. Keys/len/contains cover resident AND stored
    predicates so routing (`pred in db.tablets`) sees the whole
    dataset without loading it."""

    def __init__(self, db, store: TabletStore,
                 budget_bytes: int = 256 << 20):
        super().__init__()
        self.db = db
        self.store = store
        self.budget = budget_bytes
        self.stored: set[str] = set(store.preds())
        self._lru: OrderedDict[str, int] = OrderedDict()  # pred -> bytes
        self._saved_ts: dict[str, int] = {}  # pred -> base_ts at save
        self.resident_bytes = 0
        self.peak_resident = 0
        self.evictions = 0

    # ------------------------------------------------------------ lookup

    def get(self, pred, default=None):
        tab = dict.get(self, pred)
        if tab is None and pred in self.stored:
            pf = getattr(self.db, "prefetcher", None)
            if pf is not None:
                # async prefetch (engine/prefetch.py): consume the
                # worker's decode if one landed — fully done (hit) or
                # mid-flight (the overlap already banked is kept);
                # stale decodes (blob re-saved since scheduling) are
                # discarded inside take() via the saved-ts check
                tab = pf.take(pred, self._saved_ts.get(pred))
                if tab is None:
                    pf.miss()
            if tab is None:
                tab = self.store.load(pred, self.db.schema)
            if tab is not None:
                inc_counter("tablet_store_loads")
                dict.__setitem__(self, pred, tab)
                self._saved_ts[pred] = tab.base_ts
                self._account(pred, tab)
        if tab is None:
            return default
        if pred in self._lru:
            self._lru.move_to_end(pred)
        return tab

    def values(self):
        for pred in list(self.keys_sorted()):
            tab = self.get(pred)
            if tab is not None:
                yield tab

    def items(self):
        for pred in list(self.keys_sorted()):
            tab = self.get(pred)
            if tab is not None:
                yield pred, tab

    def keys_sorted(self):
        return sorted(set(dict.keys(self)) | self.stored)

    def __getitem__(self, pred):
        tab = self.get(pred)
        if tab is None:
            raise KeyError(pred)
        return tab

    def __setitem__(self, pred, tab):
        dict.__setitem__(self, pred, tab)
        self._account(pred, tab)

    def pop(self, pred, *default):
        self.stored.discard(pred)
        self.store.delete(pred)
        self._drop_accounting(pred)
        return dict.pop(self, pred, *default)

    def clear(self):
        for pred in list(self.stored):
            self.store.delete(pred)
        self.stored.clear()
        self._lru.clear()
        self.resident_bytes = 0
        dict.clear(self)

    def __contains__(self, pred):
        return dict.__contains__(self, pred) or pred in self.stored

    def __iter__(self):
        seen = set(dict.keys(self)) | self.stored
        return iter(sorted(seen))

    def keys(self):
        return set(dict.keys(self)) | self.stored

    def __len__(self):
        return len(set(dict.keys(self)) | self.stored)

    # ---------------------------------------------------------- eviction

    def _account(self, pred, tab):
        nbytes = self._tab_bytes(tab)
        self.resident_bytes += nbytes - self._lru.get(pred, 0)
        self._lru[pred] = nbytes
        self._lru.move_to_end(pred)
        self.peak_resident = max(self.peak_resident,
                                 self.resident_bytes)
        self._maybe_evict(exclude=pred)

    def _drop_accounting(self, pred):
        self.resident_bytes -= self._lru.pop(pred, 0)

    @staticmethod
    def _tab_bytes(tab) -> int:
        try:
            return tab.approx_bytes()
        except RuntimeError:
            return 1 << 20  # mutated mid-scan; rough placeholder

    def _maybe_evict(self, exclude=None):
        """LRU-evict CLEAN resident tablets past the budget. Dirty
        tablets (live overlay) stay; re-accounted after rollup.
        `exclude` protects the tablet being handed to the caller RIGHT
        NOW — evicting it would orphan the reference and lose the
        caller's writes."""
        if self.resident_bytes <= self.budget:
            return
        for pred in list(self._lru):
            if self.resident_bytes <= self.budget:
                return
            if pred == exclude:
                continue
            tab = dict.get(self, pred)
            if tab is None:
                self._drop_accounting(pred)
                continue
            if tab.dirty():
                continue
            self.offload(pred)

    def offload(self, pred) -> bool:
        """Persist + drop one resident tablet (clean only). The blob
        writes only when the tablet changed since its last save."""
        tab = dict.get(self, pred)
        if tab is None or tab.dirty():
            return False
        if self._saved_ts.get(pred) != tab.base_ts \
                or pred not in self.stored:
            self.store.save(tab)
            self._saved_ts[pred] = tab.base_ts
            # keep meta:max_ts ahead of every persisted base_ts — a
            # crash before flush_all would otherwise reopen with the
            # coordinator far below this tablet's base (every read a
            # StaleSnapshot until the ts catches up)
            self.store.save_max_ts(self.db.coordinator.max_assigned())
        self.stored.add(pred)
        self.db.device_cache.drop_tablet(tab)
        dict.pop(self, pred, None)
        self._drop_accounting(pred)
        self.evictions += 1
        inc_counter("tablet_store_evictions")
        return True

    def flush_all(self):
        """Persist every resident tablet (rollup first so overlays
        fold); used at close/checkpoint. Also records the coordinator
        high-water ts: a REOPENED store must resume timestamps past
        its persisted base state, or every read allocates a ts below
        the tablets' base_ts and refuses as a stale snapshot."""
        self.store.save_max_ts(self.db.coordinator.max_assigned())
        for pred in list(dict.keys(self)):
            tab = dict.get(self, pred)
            if tab is None:
                continue
            if tab.dirty():
                tab.rollup(self.db.fold_watermark())
            if not tab.dirty() and (
                    self._saved_ts.get(pred) != tab.base_ts
                    or pred not in self.stored):
                self.store.save(tab)
                self._saved_ts[pred] = tab.base_ts
                self.stored.add(pred)
        self.store.save_schema(self.db.schema.describe_all())
