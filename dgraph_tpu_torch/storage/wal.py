"""Write-ahead log: durability for committed transactions.

The reference persists every mutation through Badger's value log + Raft
WAL (raftwal/storage.go over Badger). Here the framing, CRC validation,
torn-tail truncation, and fsync policy live in the host runtime
(csrc/native.cc dgt_wal_*, bound via dgraph_tpu_torch.native.NativeWal);
records are wire-encoded engine commit tuples. A pure-Python framer
writes the same format and runs when the runtime is switched off.
Snapshotting truncates the log (ref worker/draft.go:1206
calculateSnapshot).

Port of `dgraph_tpu/storage/wal.py`: a log written by either backend of
either package replays in the other.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Iterator

from dgraph_tpu_torch import native

# Same on-disk format as csrc/native.cc (kWalMagic / frame = u32 len |
# u32 crc32 | payload): the two backends are interchangeable on the same
# file.
_MAGIC = b"DGTWAL2\x00"
_LEGACY_MAGIC = b"DGTWAL1\x00"


def _timed_fsync(fd: int) -> None:
    """fsync + dgraph_wal_fsync_seconds observation: the watchdog's
    wal_fsync_stall rule reads this histogram's tick-window p99 — a
    dying durability volume shows here long before the engine
    visibly stalls. Seconds (own bucket table in metrics.py
    BUCKETS_BY_NAME), not the default ms buckets."""
    import time

    from dgraph_tpu_torch.utils import metrics
    t0 = time.perf_counter()
    os.fsync(fd)
    metrics.observe("dgraph_wal_fsync_seconds",
                    time.perf_counter() - t0)


def raise_if_legacy_wal(path: str) -> None:
    """Pre-CRC DGTWAL1 files must fail with a recovery path, not a bare
    'bad magic' / bricked store (advisor finding). Shared by both WAL
    backends so the format knowledge lives in one place."""
    try:
        with open(path, "rb") as f:
            legacy = f.read(len(_LEGACY_MAGIC)) == _LEGACY_MAGIC
    except OSError:
        return
    if legacy:
        raise IOError(
            f"{path} uses the legacy DGTWAL1 format; export/snapshot "
            "it with a pre-DGTWAL2 build, then restore into a fresh "
            "store")


class _PyWal:
    """Fallback framer, wire-compatible with dgt_wal_*."""
    # dglint: guarded-by=*:external (appends happen only on the
    # engine's serialized write path; replay/close are lifecycle-edge
    # calls — synchronization is the caller's contract)

    def __init__(self, path: str, sync: bool = False):
        self.path = path
        self.sync = sync
        exists = os.path.exists(path)
        self._f = open(path, "ab+")
        if not exists or self._f.tell() == 0:
            self._f.write(_MAGIC)
            self._f.flush()

    def append(self, blob: bytes):
        import zlib
        self._f.write(struct.pack("<II", len(blob),
                                  zlib.crc32(blob) & 0xFFFFFFFF))
        self._f.write(blob)
        self._f.flush()
        if self.sync:
            _timed_fsync(self._f.fileno())

    def replay(self):
        import zlib
        records = []
        with open(self.path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic == _LEGACY_MAGIC:
                raise_if_legacy_wal(self.path)
            if magic != _MAGIC:
                raise IOError(f"bad WAL magic in {self.path}")
            good = f.tell()
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                n, crc = struct.unpack("<II", hdr)
                blob = f.read(n)
                if len(blob) < n or (zlib.crc32(blob) & 0xFFFFFFFF) != crc:
                    break  # torn/corrupt tail
                records.append(blob)
                good = f.tell()
        self._f.flush()
        size = os.path.getsize(self.path)
        if good < size:
            self._f.close()
            with open(self.path, "rb+") as f:
                f.truncate(good)
            self._f = open(self.path, "ab+")
        return records

    def truncate(self):
        self._f.close()
        self._f = open(self.path, "wb")
        self._f.write(_MAGIC)
        self._f.flush()
        _timed_fsync(self._f.fileno())
        self._f = open(self.path, "ab+")

    def flush(self):
        self._f.flush()
        _timed_fsync(self._f.fileno())

    def close(self):
        self._f.close()


def _decode_record(blob: bytes) -> Any:
    """Records are wire-encoded (dgraph_tpu_torch.wire, version-tagged first
    byte); stores written before the wire format existed used pickle —
    wire.loads_compat (the one migration shim) replays those too so an
    upgrade never bricks a WAL."""
    from dgraph_tpu_torch.wire import loads_compat
    return loads_compat(blob)


class Wal:
    """Record log for engine commits; native-backed unless the runtime
    is switched off. With `key`, every record blob is AES-GCM sealed
    before framing (encryption at rest, storage/enc.py; ref ee/enc)."""

    def __init__(self, path: str, sync: bool = False,
                 key: bytes | None = None):
        self.path = path
        self.sync = sync
        self.key = key
        if native.available():
            self._w = native.NativeWal(path, sync)
            self.native = True
        else:
            self._w = _PyWal(path, sync)
            self.native = False

    def append(self, record: Any):
        from dgraph_tpu_torch.storage.enc import encrypt_blob
        from dgraph_tpu_torch.utils import failpoint
        from dgraph_tpu_torch.utils.tracing import span as _span
        from dgraph_tpu_torch.wire import dumps
        with _span("wal.append") as sp:
            # chaos seam: delay/fail durability — an armed error here
            # models a full disk / dying volume before the frame lands
            failpoint.fire("wal.append")
            blob = encrypt_blob(dumps(record), self.key)
            sp["bytes"] = len(blob)
            if self.native and self.sync:
                # the native backend fsyncs inside dgt_wal_append —
                # time the whole durable append (fsync dominates it)
                # so the stall histogram covers both backends
                import time

                from dgraph_tpu_torch.utils import metrics
                t0 = time.perf_counter()
                self._w.append(blob)
                metrics.observe("dgraph_wal_fsync_seconds",
                                time.perf_counter() - t0)
            else:
                self._w.append(blob)

    def replay(self) -> Iterator[Any]:
        from dgraph_tpu_torch.storage.enc import decrypt_blob
        for blob in self._w.replay():
            yield _decode_record(decrypt_blob(blob, self.key))

    def truncate(self):
        """Reset after a snapshot has captured state (ref raft WAL
        truncation below snapshot index, raftwal/storage.go:594)."""
        self._w.truncate()

    def flush(self):
        self._w.flush()

    def close(self):
        self._w.close()
