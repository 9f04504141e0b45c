"""Binary backup/restore with incremental manifest chains (ee/backup/),
plus point-in-time restore composed from the chain + captured CDC tail.

The reference streams Badger keys with version > sinceTs to a URI
handler (file/S3/minio) and records a manifest chain; restore replays
the chain in order (ee/backup/backup.go:88 WriteBackup,
handler.go:159 NewUriHandler, restore.go:37).

Our unit of incremental change is the tablet: a backup serializes every
tablet whose max_commit_ts (or base_ts, post-rollup) moved past the
chain's last read_ts, plus the schema and coordinator watermarks.
Restore folds the chain newest-wins per tablet. Artifacts are
gzip-compressed wire payloads, optionally sealed with AES-GCM
(storage/enc.py), stamped with the at-rest format_version
(storage/versions.py; unstamped legacy chains load as version 0).

Point-in-time restore (restore_to_ts): each backup also captures the
per-predicate RAW change-log tail (cdc/changelog.read_raw — original
EdgeOps, whole commits, ascending ts) covering its (since_ts, read_ts]
window. Restoring to an arbitrary commit_ts T replays the chain's
entries at or below T as the base, then applies the NEXT entry's
captured batches with commit_ts <= T through the SAME replicated-record
apply path a tablet move uses (("move_delta", ...) ->
engine/db.apply_record: tab.apply + cdc.append with identical offsets),
so the result is byte-identical to an oracle that replayed the whole
WAL and stopped at T. The raw ring is bounded (DEFAULT_RAW_CAP): when
eviction has moved past since_ts the entry records a per-predicate
coverage floor, and a target inside the uncovered window raises the
typed PitrCoverageError instead of silently under-restoring.

URI handlers (storage/uri.py, ref ee/backup/handler.go): file paths
and file:// everywhere; s3://bucket/prefix and minio://host:port/bucket
speak the S3 REST protocol with SigV4 from env credentials.

Port of `dgraph_tpu/storage/backup.py`. A restore builds its tablets,
their trained vector indexes included, on the engine's device: the one
of `db`, or of a fresh engine on `device` (None: the card). One
difference: a chain entry whose schema text equals the engine's does
not alter it again. The reference re-alters at every entry, which
rebinds every listed predicate's schema and so drops the trained index
an earlier entry restored (its chain restores retrain at the next
rollup); the port keeps it, and its restored tablets dump as the
source's did.
"""

from __future__ import annotations

import gzip
import json
import time
from typing import Optional

from dgraph_tpu_torch.storage.enc import decrypt_blob, encrypt_blob
from dgraph_tpu_torch.storage.uri import new_uri_handler
from dgraph_tpu_torch.storage.versions import FORMAT_VERSION, check_format

MANIFEST = "manifest.json"


class PitrCoverageError(ValueError):
    """The restore target falls inside a window the chain cannot
    reconstruct: the bounded raw change ring had already evicted part
    of (base watermark, floor_ts] when the covering backup ran, so the
    replay from the base has a hole. Restore to a chain boundary
    instead; shorten the backup interval (or raise the raw ring cap)
    to keep windows fully covered."""

    def __init__(self, pred: str, have_ts: int, floor_ts: int,
                 to_ts: int):
        self.pred = pred
        self.have_ts = have_ts
        self.floor_ts = floor_ts
        self.to_ts = to_ts
        super().__init__(
            f"cannot restore {pred!r} to ts {to_ts}: the covering "
            f"backup's change capture starts at ts {floor_ts} but the "
            f"chain's base state ends at ts {have_ts} — commits in "
            f"({have_ts}, {floor_ts}] were evicted before the backup "
            f"ran; restore to a chain boundary (ts <= {have_ts} or "
            f"the covering entry's read_ts) instead")


def _read_chain(handler) -> list[dict]:
    raw = handler.get(MANIFEST)
    return json.loads(raw) if raw else []


def read_manifests(dest: str) -> list[dict]:
    return _read_chain(new_uri_handler(dest))


def _capture_changelog(db, pred: str, since_ts: int,
                       read_ts: int) -> tuple[list, int]:
    """Drain the predicate's RAW change ring for commits in
    (since_ts, read_ts]: [(commit_ts, [EdgeOp, ...]), ...] plus the
    coverage floor — since_ts when the ring still held the whole
    window, else the eviction point (commits at or below it are only
    in the base state, not replayable)."""
    from dgraph_tpu_torch.cdc.changelog import OffsetTruncated, offset_for_ts
    after = offset_for_ts(since_ts)
    floor_ts = since_ts
    batches: list = []
    while True:
        try:
            got = db.cdc.read_raw(pred, after=after, limit=1024)
        except OffsetTruncated as e:
            # the bounded ring evicted past since_ts: coverage starts
            # at the eviction point; anything gathered below is moot
            after = e.floor
            floor_ts = max(floor_ts, e.resync_ts)
            batches = []
            continue
        fresh = [(int(ts), list(ops)) for ts, ops in got["batches"]]
        batches.extend(fresh)
        if not fresh:
            break
        after = offset_for_ts(batches[-1][0])
    # a commit racing the backup can land past read_ts mid-capture:
    # keep the entry self-consistent with its stamped window
    return [b for b in batches if b[0] <= read_ts], floor_ts


def backup(db, dest: str, force_full: bool = False,
           key: Optional[bytes] = None) -> dict:
    """Write a full or incremental backup; returns its manifest entry.
    Incremental = tablets whose state moved past the chain's last
    read_ts (ref backup.go Request.since logic). Tablets ship in the
    dump_tablet shape (storage/snapshot.py — the one wire shape shared
    by snapshots, moves and the cold store), so backups carry the full
    fidelity restore needs: unfolded deltas, commit watermarks and
    trained ANN codebooks included."""
    from dgraph_tpu_torch.storage.snapshot import dump_tablet
    handler = new_uri_handler(dest)
    chain = _read_chain(handler)
    since = 0 if (force_full or not chain) else chain[-1]["read_ts"]

    db.rollup_all(window=0)  # backups must capture every commit
    read_ts = db.coordinator.max_assigned()
    tablets = {}
    changelog = {}
    changelog_floor = {}
    for pred, tab in db.tablets.items():
        moved = max(tab.max_commit_ts, tab.base_ts)
        if since and moved <= since:
            continue
        tablets[pred] = dump_tablet(tab)
        batches, floor_ts = _capture_changelog(db, pred, since, read_ts)
        changelog[pred] = batches
        changelog_floor[pred] = floor_ts
    payload = {
        "format_version": FORMAT_VERSION,
        "schema": db.schema.describe_all(),
        "tablets": tablets,
        # the PITR tail: raw per-predicate change batches covering
        # (changelog_floor[pred], read_ts] — restore_to_ts replays
        # them through the move_delta apply path
        "changelog": changelog,
        "changelog_floor": changelog_floor,
        "read_ts": read_ts,
        "since_ts": since,
        "next_uid": db.coordinator._next_uid,
    }
    # predicates the chain believes exist but the store no longer has:
    # record them as dropped so restore doesn't resurrect deleted data
    # (drop_attr / drop_all between backups)
    chain_preds: set = set()
    for e in chain:
        chain_preds |= set(e.get("predicates", []))
        chain_preds -= set(e.get("dropped", []))
    dropped = sorted(chain_preds - set(db.tablets))

    name = f"backup-{since}-{read_ts}.gz"
    from dgraph_tpu_torch import wire
    blob = gzip.compress(wire.dumps(payload))
    handler.put(name, encrypt_blob(blob, key))
    entry = {"type": "full" if since == 0 else "incremental",
             "format_version": FORMAT_VERSION,
             "since_ts": since, "read_ts": read_ts, "file": name,
             "encrypted": key is not None,
             # wall clock: manifest stamps are user-visible instants
             "unix_ts": int(time.time()),  # dglint: disable=DG06
             "predicates": sorted(tablets),
             "dropped": dropped}
    chain.append(entry)
    handler.put(MANIFEST, json.dumps(chain, indent=2).encode())
    return entry


def _entry_payload(handler, entry: dict,
                   key: Optional[bytes]) -> dict:
    raw = handler.get(entry["file"])
    if raw is None:
        raise FileNotFoundError(
            f"backup artifact {entry['file']!r} missing from chain")
    from dgraph_tpu_torch.storage.snapshot import _load_payload
    payload = _load_payload(gzip.decompress(decrypt_blob(raw, key)))
    check_format(payload.get("format_version", 0),
                 f"backup artifact {entry['file']!r}")
    return payload


def _alter_if_changed(db, schema_text: str) -> None:
    """alter() unless the engine already holds exactly this schema: an
    alter rebinds every listed predicate's schema, which invalidates
    the vector indexes cached against the old objects."""
    if schema_text != db.schema.describe_all():
        db.alter(schema_text)


def _apply_entry(payload: dict, db) -> None:
    """Fold one chain entry into the engine, newest-wins per tablet.
    Handles every historical tablet shape through restore_tablet's
    migration seams (raw `values`, dense pre-compression arrays)."""
    from dgraph_tpu_torch.storage.snapshot import restore_tablet
    _alter_if_changed(db, payload["schema"])
    for pred, st in payload["tablets"].items():
        ps = db.schema.get_or_default(pred)
        tab = restore_tablet(pred, ps, st, db.device)
        db.tablets[pred] = tab
        db.coordinator.should_serve(pred)
        # same floor contract as restore_state: history at or below
        # the restored watermark lives in the base state, not the log
        db.cdc.reset_floor(pred, max(tab.max_commit_ts, tab.base_ts))


def restore(dest: str, db=None, key: Optional[bytes] = None,
            device=None):
    """Rebuild an engine (`db`, or a fresh one on `device`) from the
    manifest chain, newest-wins per tablet (ref restore.go:37 RunRestore
    ordering)."""
    from dgraph_tpu_torch.engine.db import GraphDB

    handler = new_uri_handler(dest)
    chain = _read_chain(handler)
    if not chain:
        raise FileNotFoundError(f"no backup manifest under {dest!r}")
    db = db or GraphDB(device=device)
    max_ts = 0
    next_uid = 1
    for entry in chain:
        payload = _entry_payload(handler, entry, key)
        _apply_entry(payload, db)
        for pred in entry.get("dropped", []):
            db.tablets.pop(pred, None)
            db.schema.delete_predicate(pred)
        max_ts = max(max_ts, payload["read_ts"])
        next_uid = max(next_uid, payload["next_uid"])
    db.fast_forward_ts(max_ts)
    db.coordinator.bump_uids(next_uid - 1)
    return db


def restore_to_ts(dest: str, to_ts: int, db=None,
                  key: Optional[bytes] = None, device=None):
    """Point-in-time restore: materialize the store as of commit_ts
    `to_ts` — ANY committed instant the chain covers, not just backup
    boundaries. Chain entries with read_ts <= to_ts restore as the
    base; the next entry's captured change batches replay on top
    through the move_delta apply path (identical tablet state AND CDC
    offsets to a full-WAL oracle replay stopped at to_ts — the parity
    tools/dr_smoke.py gates). Raises PitrCoverageError when to_ts
    falls in a window the bounded raw ring had evicted before the
    covering backup ran, and ValueError for targets past the chain
    head or under a version-0 (pre-capture) covering entry. The engine
    is `db`, or a fresh one on `device` (None: the card)."""
    from dgraph_tpu_torch.engine.db import GraphDB

    handler = new_uri_handler(dest)
    chain = _read_chain(handler)
    if not chain:
        raise FileNotFoundError(f"no backup manifest under {dest!r}")
    to_ts = int(to_ts)
    head_ts = chain[-1]["read_ts"]
    if to_ts > head_ts:
        raise ValueError(
            f"cannot restore to ts {to_ts}: the chain ends at read_ts "
            f"{head_ts}; run a newer backup first")
    db = db or GraphDB(device=device)
    next_uid = 1
    base_top = 0
    for entry in chain:
        if entry["read_ts"] > to_ts:
            break
        payload = _entry_payload(handler, entry, key)
        _apply_entry(payload, db)
        for pred in entry.get("dropped", []):
            db.tablets.pop(pred, None)
            db.schema.delete_predicate(pred)
        base_top = max(base_top, payload["read_ts"])
        next_uid = max(next_uid, payload["next_uid"])
    if to_ts > base_top:
        # to_ts sits strictly inside the NEXT entry's window: replay
        # its captured tail up to the target
        tail = next(e for e in chain if e["read_ts"] > to_ts)
        payload = _entry_payload(handler, tail, key)
        changelog = payload.get("changelog")
        if changelog is None:
            raise ValueError(
                f"backup {tail['file']!r} predates change capture "
                f"(format_version 0): restore only to chain "
                f"boundaries, nearest are ts {base_top} and "
                f"{tail['read_ts']}")
        _alter_if_changed(db, payload["schema"])
        floors = payload.get("changelog_floor", {})
        for pred in sorted(changelog):
            have = db.tablets[pred].max_commit_ts \
                if pred in db.tablets else 0
            floor_ts = int(floors.get(pred, tail["since_ts"]))
            if floor_ts > have:
                # commits in (have, floor_ts] were evicted before the
                # covering backup ran — nothing can reconstruct them
                raise PitrCoverageError(pred, have, floor_ts, to_ts)
            batches = [(ts, ops) for ts, ops in changelog[pred]
                       if have < ts <= to_ts]
            if batches:
                db.apply_record(("move_delta", pred, batches))
        next_uid = max(next_uid, payload["next_uid"])
    db.fast_forward_ts(to_ts)
    # the tail entry's uid watermark may exceed what existed at to_ts;
    # over-reserving is safe (no allocation below it can collide),
    # under-reserving is not — move_delta already bumped per-op uids
    db.coordinator.bump_uids(next_uid - 1)
    return db
