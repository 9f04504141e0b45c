"""Bulk store seeding: synthesize cold-store blobs without apply().

The per-edge ingest path (mutate -> overlay delta -> rollup fold) costs
microseconds per triple in Python — honest for OLTP, hopeless for
standing up a 500M-edge regime (BENCH_500M, tools/bench_500m.py) where
seeding would take days. The reference has the same split: live writes
go through the Raft/posting pipeline while dgraph bulk (bulk/loader.go,
bulk/reduce.go) writes finished Badger SSTs directly. This module is
that bulk lane: it builds the EXACT wire payload TabletStore.save would
have produced for a rolled-up tablet — group-varint uid planes, packed
value columns, token index — straight from numpy arrays, and puts it
into the KV. A store seeded here is indistinguishable from one grown
through mutations: restore_tablet materializes it, the prefetch pipeline
decodes it, parity oracles read it.

Invariants the synthesizer must honor (or lazy loads go subtly wrong):
  - every uid vector (edges, reverse, index postings) sorted ascending;
  - index keys carry the tokenizer identifier byte (utils/keys.token_bytes)
    exactly as Tablet._tokens would emit them;
  - values_pk columns are parallel and walk src in ascending-uid order
    (the deterministic dict order _pack_values would have produced);
  - base_ts == max_commit_ts and meta:max_ts saved at or above it,
    else every read on the reopened store is a StaleSnapshot.

Port of `dgraph_tpu/storage/bulkseed.py`: a copy, its imports pointed
at this package.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from dgraph_tpu_torch import wire
from dgraph_tpu_torch.models.tokenizer import get_tokenizer
from dgraph_tpu_torch.models.types import TypeID
from dgraph_tpu_torch.utils.keys import token_bytes

_TAB_PREFIX = b"tab:"


def _split_sorted(uids: np.ndarray, codes: np.ndarray):
    """Group sorted-ascending `uids` by parallel `codes`: yields
    (code, uid_subset) with each subset still ascending (stable sort on
    codes preserves the uid order inside a group)."""
    order = np.argsort(codes, kind="stable")
    sc = codes[order]
    su = uids[order]
    bounds = np.flatnonzero(np.diff(sc)) + 1
    starts = np.concatenate(([0], bounds))
    ends = np.concatenate((bounds, [len(sc)]))
    for s, e in zip(starts.tolist(), ends.tolist()):
        yield sc[s], su[s:e]


def _index_gv(tokenizers, tid: TypeID, uids: np.ndarray,
              codes: np.ndarray, decode) -> dict:
    """Token index plane for a single-tokenizer value column. `codes`
    is the per-uid value in token space already (int key or label id);
    `decode(code)` maps it to the tokenizer's token (int or str)."""
    from dgraph_tpu_torch.ops.codec import gv_encode
    out: dict[bytes, bytes] = {}
    for tname in tokenizers:
        spec = get_tokenizer(tname)
        for code, sub in _split_sorted(uids, codes):
            out[token_bytes(spec.ident, decode(code))] = gv_encode(sub)
    return out


def _blob(schema_text: str, tablet: dict) -> bytes:
    return wire.dumps({"schema": schema_text, "tablet": tablet})


def _base(base_ts: int) -> dict:
    return {"reverse_gv": {}, "edge_facets": {}, "deltas": [],
            "base_ts": int(base_ts), "max_commit_ts": int(base_ts)}


def int_tablet_blob(schema_text: str, uids: np.ndarray,
                    vals: np.ndarray, base_ts: int,
                    tokenizers=("int",)) -> bytes:
    """int-valued predicate: one posting per uid, @index(int)."""
    uids = np.asarray(uids, np.uint64)
    vals = np.asarray(vals, np.int64)
    tab = _base(base_ts)
    tab["edges_gv"] = {}
    tab["values_pk"] = {"src": uids, "tid": bytes([int(TypeID.INT)]) * len(uids),
                        "pay": vals.tolist(), "lang": [], "facets": []}
    tab["index_gv"] = _index_gv(tokenizers, TypeID.INT, uids, vals,
                                lambda c: int(c))
    return _blob(schema_text, tab)


def str_tablet_blob(schema_text: str, uids: np.ndarray,
                    labels: list[str], codes: np.ndarray, base_ts: int,
                    tokenizers=("exact",)) -> bytes:
    """string-valued predicate: per-uid label picked by `codes` into
    `labels`, @index(exact) (or any string tokenizer set)."""
    uids = np.asarray(uids, np.uint64)
    codes = np.asarray(codes, np.int64)
    tab = _base(base_ts)
    tab["edges_gv"] = {}
    pay = [labels[c] for c in codes.tolist()]
    tab["values_pk"] = {"src": uids,
                        "tid": bytes([int(TypeID.STRING)]) * len(uids),
                        "pay": pay, "lang": [], "facets": []}
    tab["index_gv"] = _index_gv(tokenizers, TypeID.STRING, uids, codes,
                                lambda c: labels[int(c)])
    return _blob(schema_text, tab)


def uid_tablet_blob(schema_text: str, srcs: np.ndarray,
                    indptr: np.ndarray, dsts: np.ndarray,
                    base_ts: int) -> bytes:
    """uid predicate from CSR form: srcs[i] owns dsts[indptr[i]:
    indptr[i+1]] (each row must already be sorted ascending)."""
    from dgraph_tpu_torch.ops.codec import gv_encode
    srcs = np.asarray(srcs, np.uint64)
    dsts = np.asarray(dsts, np.uint64)
    tab = _base(base_ts)
    edges: dict[int, bytes] = {}
    ip = np.asarray(indptr, np.int64).tolist()
    for i, src in enumerate(srcs.tolist()):
        row = dsts[ip[i]:ip[i + 1]]
        if len(row):
            edges[int(src)] = gv_encode(row)
    tab["edges_gv"] = edges
    tab["values_pk"] = {"src": np.empty(0, np.uint64), "tid": b"",
                        "pay": [], "lang": [], "facets": []}
    tab["index_gv"] = {}
    return _blob(schema_text, tab)


def seed_store(store, schema_text: str,
               blobs: Iterable[tuple[str, bytes]], max_ts: int) -> int:
    """Install synthesized blobs into a TabletStore: per-pred tablet
    payloads + the meta plane (schema text, coordinator high-water ts).
    Returns total bytes written. Call store.compact() afterwards so the
    WAL folds into one snapshot before the bench reopens the store."""
    total = 0
    for pred, blob in blobs:
        store.kv.put(_TAB_PREFIX + pred.encode("utf-8"), blob)
        total += len(blob)
    store.save_schema(schema_text)
    store.save_max_ts(int(max_ts))
    return total
