"""Store snapshots: serialize a GraphDB's rolled-up state.

The analogue of the reference bulk loader's output (a ready Badger p/
directory, bulk/reduce.go writing SSTs) and the base artifact for
backup/restore (ee/backup/) and Raft InstallSnapshot payloads
(worker/snapshot.go doStreamSnapshot/populateSnapshot). Format: a
wire-encoded payload of schema text + per-tablet base arrays +
coordinator counters; the file form is gzip-compressed with a magic
header.

Port of `dgraph_tpu/storage/snapshot.py`: the same payload and file
bytes. A restored tablet, and its vector index, land on the device of
the engine it is restored into.
"""

from __future__ import annotations

import gzip
import os


def _load_payload(blob: bytes):
    """Wire-encoded (version byte 0x01); files written before the wire
    format existed fall back to wire.loads_compat, the one migration
    shim."""
    from dgraph_tpu_torch import wire
    return wire.loads_compat(blob)

SNAPSHOT_MAGIC = b"DGTPU-SNAP-1"


def _gv_dict(d: dict) -> dict:
    """{key -> sorted uint64 uids} -> {key -> group-varint stream}:
    the at-rest form of every posting surface (ref codec/codec.go —
    the reference never persists a dense uid list either), byte-
    identical to the reference's native and numpy encoders
    (ops/codec.gv_encode)."""
    from dgraph_tpu_torch.ops.codec import gv_encode
    return {k: gv_encode(v) for k, v in d.items()}


def _ungv_dict(d: dict) -> dict:
    import numpy as np

    from dgraph_tpu_torch.ops.codec import gv_decode
    return {k: np.asarray(gv_decode(v), np.uint64)
            for k, v in d.items()}


def _pack_values(values: dict) -> dict:
    """{src -> [Posting]} -> parallel columns (src array, tid bytes,
    payload list, sparse lang/facet maps). One Posting costs ~8 bytes
    of TLV framing and ~20 µs of generic record decode on the wire;
    value-dominated tablets (the LDBC norm) made the per-Posting walk
    the single largest line item of writing a snapshot, so values
    persist columnar like every other plane. Column order is the
    values-dict walk order — deterministic, and inverted exactly by
    _unpack_values."""
    import numpy as np
    srcs: list[int] = []
    tids = bytearray()
    pays: list = []
    langs: list[tuple[int, str]] = []
    facets: list[tuple[int, dict]] = []
    i = 0
    for src, posts in values.items():
        for p in posts:
            srcs.append(src)
            tids.append(int(p.value.tid))
            pays.append(p.value.value)
            if p.lang:
                langs.append((i, p.lang))
            if p.facets:
                facets.append((i, p.facets))
            i += 1
    return {"src": np.asarray(srcs, np.uint64), "tid": bytes(tids),
            "pay": pays, "lang": langs, "facets": facets}


def _unpack_values(pk: dict) -> dict:
    from dgraph_tpu_torch.models.types import TypeID, Val
    from dgraph_tpu_torch.storage.tablet import Posting
    langs = dict(pk["lang"])
    facets = dict(pk["facets"])
    out: dict[int, list] = {}
    for i, (s, t, v) in enumerate(zip(pk["src"].tolist(),
                                      pk["tid"], pk["pay"])):
        out.setdefault(s, []).append(
            Posting(Val(TypeID(t), v), langs.get(i, ""),
                    facets.get(i, {})))
    return out


def dump_tablet(tab) -> dict:
    """One tablet's state — the single wire shape shared by snapshots,
    backups, tablet moves and the cold-tablet store
    (engine/lazy_tablets). Add new Tablet fields HERE.

    The uid-array planes (edges / reverse / token index) persist
    group-varint delta-compressed — cold tablets stay compressed at
    rest in the KV store at ~2 B/uid instead of dense 8 B/uid, the
    same split the reference keeps in codec/ — and decode on
    materialization (restore_tablet).

    Unfolded overlay deltas ARE included: the rollup watermark can be
    pinned below the newest commits (active txns, pinned snapshot
    readers), and a payload of base arrays alone would silently drop
    those committed writes from snapshots/backups."""
    out = {
        "edges_gv": _gv_dict(tab.edges),
        "reverse_gv": _gv_dict(tab.reverse),
        "values_pk": _pack_values(tab.values),
        "index_gv": _gv_dict(tab.index),
        "edge_facets": tab.edge_facets,
        "base_ts": tab.base_ts,
        "deltas": tab.deltas,
        "max_commit_ts": tab.max_commit_ts,
    }
    # trained quantized ANN index (storage/vecstore.py): ships with
    # the tablet so bulk-loaded / moved / restored tablets boot with
    # their codebooks instead of retraining k-means at first query
    ivf = getattr(tab, "vector_ivf", lambda: None)()
    if ivf is not None:
        from dgraph_tpu_torch.storage.vecstore import ivf_to_payload
        out["vec_ivf"] = ivf_to_payload(ivf)
    return out


def restore_tablet(pred: str, schema, st: dict, device=None):
    """Inverse of dump_tablet -> a fresh Tablet on `device` (None: the
    card). Pre-compression payloads (dense "edges"/"reverse"/"index"
    keys) still restore — the one migration seam, same policy as
    loads_compat."""
    from dgraph_tpu_torch.storage.tablet import Tablet
    tab = Tablet(pred, schema, device=device)
    tab.edges = _ungv_dict(st["edges_gv"]) if "edges_gv" in st \
        else st["edges"]
    tab.reverse = _ungv_dict(st["reverse_gv"]) if "reverse_gv" in st \
        else st["reverse"]
    tab.values = _unpack_values(st["values_pk"]) \
        if "values_pk" in st else st["values"]
    tab.index = _ungv_dict(st["index_gv"]) if "index_gv" in st \
        else st["index"]
    tab.edge_facets = st["edge_facets"]
    tab.base_ts = st["base_ts"]
    tab.deltas = list(st.get("deltas", ()))  # absent in old payloads
    tab.max_commit_ts = int(st.get("max_commit_ts", tab.base_ts))
    for ts, _ops in tab.deltas:
        tab.max_commit_ts = max(tab.max_commit_ts, ts)
    if "vec_ivf" in st:
        from dgraph_tpu_torch.storage.vecstore import ivf_from_payload
        tab._vec_ivf = (tab.base_ts, tab.schema,
                        ivf_from_payload(st["vec_ivf"], device))
    return tab


def dump_state(db) -> dict:
    """GraphDB -> one picklable state payload at a single ts. Deltas
    fold first where the watermark allows; whatever must stay unfolded
    (active txns / pinned readers hold the watermark) ships inside
    dump_tablet's deltas, so the payload is complete either way."""
    from dgraph_tpu_torch.storage.versions import FORMAT_VERSION
    db.rollup_all(window=0)
    tablets = {pred: dump_tablet(tab)
               for pred, tab in db.tablets.items()}
    return {
        # at-rest format stamp (storage/versions.py): payloads written
        # before the stamp existed carry no key and load as version 0
        # — the pinned legacy contract (tests/test_format_version.py)
        "format_version": FORMAT_VERSION,
        "schema": db.schema.describe_all(),
        "tablets": tablets,
        "max_ts": db.coordinator.max_assigned(),
        "next_uid": db.coordinator._next_uid,
        # replicated-but-undecided cross-group stages: a member
        # installing this snapshot must still be able to apply the
        # xfinalize records that follow it in the log
        "pending_txns": {ts: (list(ops), list(keys))
                         for ts, (ops, keys)
                         in db.pending_txns.items()},
        # moved-away / split-partial tombstones: a member restoring
        # this snapshot must keep answering stale-routed requests
        # with a typed misroute, never silently-partial rows
        "moved_out": dict(getattr(db, "moved_out", {})),
        "split_partial": sorted(getattr(db, "split_partial", ())),
    }


def restore_state(payload: dict, db=None, device=None):
    """State payload -> GraphDB (by default a fresh one on `device`,
    None: the card, with the plan cache off, as the port's engine
    has no query path yet). Refuses payloads stamped NEWER than this
    build understands (typed UnsupportedFormat); unstamped legacy
    payloads are version 0 and restore identically."""
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.storage.versions import check_format

    check_format(payload.get("format_version", 0), "snapshot payload")
    db = db or GraphDB(plan_cache_size=0, device=device)
    db.alter(payload["schema"])
    for pred, st in payload["tablets"].items():
        ps = db.schema.get_or_default(pred)
        tab = restore_tablet(pred, ps, st, db.device)
        db.tablets[pred] = tab
        db.coordinator.should_serve(pred)
        # CDC floor: history at or below the restored base lives in
        # the base state, not the change log — a subscriber resuming
        # from an older offset must get OffsetTruncated (re-sync via
        # snapshot read + resubscribe), never a silent gap
        db.cdc.reset_floor(pred, tab.max_commit_ts)
    db.coordinator.observe_ts(payload["max_ts"])
    db.coordinator.bump_uids(payload["next_uid"] - 1)
    db.pending_txns = {int(ts): (list(ops), list(keys))
                       for ts, (ops, keys)
                       in payload.get("pending_txns", {}).items()}
    db.moved_out = {p: int(g) for p, g
                    in payload.get("moved_out", {}).items()}
    db.split_partial = set(payload.get("split_partial", ()))
    return db


def save_snapshot(db, path: str):
    """Write the rolled-up store to one file. The gzip member pins
    mtime=0 so identical state produces identical FILE BYTES — the
    determinism contract distributed ingest's retried reduce shards
    are checked against (ingest/distributed.py)."""
    payload = dump_state(db)
    tmp = path + ".tmp"
    from dgraph_tpu_torch import wire
    # compresslevel=6: level 9 costs ~7x the CPU of 6 for ~1% smaller
    # output on wire-encoded tablet payloads — at bulk-ingest scale
    # the snapshot encode IS the reduce tail, so the default-9 write
    # was the single largest line item of a shard's wall clock
    with open(tmp, "wb") as raw, \
            gzip.GzipFile(filename="", fileobj=raw, mode="wb",
                          mtime=0, compresslevel=6) as f:
        f.write(SNAPSHOT_MAGIC)
        f.write(wire.dumps(payload))
    os.replace(tmp, path)


def load_snapshot(path: str, db=None, device=None):
    """Restore a GraphDB from a snapshot file (by default a fresh one
    on `device`, as in restore_state)."""
    with gzip.open(path, "rb") as f:
        magic = f.read(len(SNAPSHOT_MAGIC))
        if magic != SNAPSHOT_MAGIC:
            raise ValueError(f"{path!r} is not a dgraph-tpu snapshot")
        payload = _load_payload(f.read())
    return restore_state(payload, db, device)
