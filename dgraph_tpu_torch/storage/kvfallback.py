"""The cold store's key-value store: a dict with WAL-file persistence
through the wire-compatible _PyWal framer. Records and snapshots are
wire-encoded (dgraph_tpu_torch.wire) so a store written here stays
readable by any build; pre-wire pickle payloads are replayed once via
wire.loads_compat (the migration shim).

Port of `dgraph_tpu/storage/kvfallback.py`, the reference's stand-in
for its native LSM store (`native.NativeKV`) when the C++ runtime does
not build. The port has no native runtime, so every store-backed
engine of the port uses this store; its `SNAPSHOT.py` and `WAL` files
are byte-for-byte those the reference writes in the same case, and a
store written by either package opens in the other."""

from __future__ import annotations

import os

from dgraph_tpu_torch.wire import dumps as wire_dumps
from dgraph_tpu_torch.wire import loads_compat as wire_loads_compat


class PyKV:
    def __init__(self, directory: str, sync: bool = False):
        from dgraph_tpu_torch.storage.wal import _PyWal
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        self._m: dict[bytes, bytes] = {}
        snap = os.path.join(directory, "SNAPSHOT.py")
        if os.path.exists(snap):
            with open(snap, "rb") as f:
                self._m = wire_loads_compat(f.read())
        self._wal = _PyWal(os.path.join(directory, "WAL"), sync)
        for blob in self._wal.replay():
            op, k, v = wire_loads_compat(blob)
            if op == 0:
                self._m[k] = v
            else:
                self._m.pop(k, None)

    def put(self, key: bytes, val: bytes):
        self._wal.append(wire_dumps((0, key, val)))
        self._m[key] = val

    def delete(self, key: bytes):
        self._wal.append(wire_dumps((1, key, None)))
        self._m.pop(key, None)

    def get(self, key: bytes):
        return self._m.get(key)

    def __len__(self):
        return len(self._m)

    def scan(self, prefix: bytes = b""):
        for k in sorted(self._m):
            if k.startswith(prefix):
                yield k, self._m[k]

    def flush(self):
        self._wal.flush()

    def snapshot(self):
        tmp = os.path.join(self._dir, "SNAPSHOT.py.tmp")
        with open(tmp, "wb") as f:
            f.write(wire_dumps(self._m))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self._dir, "SNAPSHOT.py"))
        self._wal.truncate()

    def close(self):
        self._wal.close()
