"""Online live loader: batched transactional ingest with conflict-key
scheduling.

Re-provides dgraph/cmd/live/ semantics: chunked parse, N-quads grouped
into batches (default 1000), batches whose conflict keys overlap an
in-flight batch are held back so they don't abort each other
(live/batch.go:239 conflictKeysForNQuad, :340 addConflictKeys), aborted
batches retry indefinitely.

Port of `dgraph_tpu/ingest/live.py`: a copy, its imports pointed
at this package.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

from dgraph_tpu_torch.cluster.coordinator import TxnAborted
from dgraph_tpu_torch.engine.db import GraphDB
from dgraph_tpu_torch.gql.nquad import NQuad
from dgraph_tpu_torch.ingest.chunker import chunk_file
from dgraph_tpu_torch.ingest.xidmap import XidMap

DEFAULT_BATCH = 1000
DEFAULT_CONCURRENCY = 4


def _conflict_keys(nqs: list[NQuad]) -> set[int]:
    """Approximation of the per-nquad conflict fingerprint
    (ref live/batch.go:239 conflictKeysForNQuad: pred+subject)."""
    return {zlib.crc32(f"{nq.predicate}\x00{nq.subject}".encode())
            for nq in nqs}


def live_load(db: GraphDB, paths: Iterable[str] = (), *,
              nquads: Optional[Iterator[list[NQuad]]] = None,
              schema: str = "", batch_size: int = DEFAULT_BATCH,
              concurrency: int = DEFAULT_CONCURRENCY,
              xidmap: Optional[XidMap] = None) -> dict:
    """Load into a live GraphDB through real transactions.
    Returns {"nquads": N, "txns": M, "aborts": K}."""
    if schema:
        db.alter(schema)
    xidmap = xidmap or XidMap(db.coordinator)
    stats = {"nquads": 0, "txns": 0, "aborts": 0, "errors": 0}
    stats_lock = threading.Lock()

    # conflict-key scheduler state (ref live/batch.go:340)
    inflight: set[int] = set()
    cv = threading.Condition()

    def batches():
        buf: list[NQuad] = []
        for p in paths:
            for chunk in chunk_file(p):
                buf.extend(chunk)
                while len(buf) >= batch_size:
                    yield buf[:batch_size]
                    buf = buf[batch_size:]
        if nquads is not None:
            for chunk in nquads:
                buf.extend(chunk)
                while len(buf) >= batch_size:
                    yield buf[:batch_size]
                    buf = buf[batch_size:]
        if buf:
            yield buf

    def resolve(nqs: list[NQuad]) -> list[NQuad]:
        out = []
        for nq in nqs:
            sub = nq.subject
            if sub.startswith("_:") or not _is_uid_lit(sub):
                sub = hex(xidmap.assign(sub))
            obj = nq.object_id
            if obj and (obj.startswith("_:") or not _is_uid_lit(obj)):
                obj = hex(xidmap.assign(obj))
            out.append(dataclasses.replace(nq, subject=sub, object_id=obj))
        return out

    def run_batch(nqs: list[NQuad], keys: set[int]):
        ok = False
        try:
            while True:
                txn = db.new_txn()
                try:
                    db._stage(txn, [(nq, False) for nq in nqs])
                    db.commit(txn)
                    ok = True
                    break
                except TxnAborted:
                    db.discard(txn)
                    with stats_lock:
                        stats["aborts"] += 1
                    continue  # infinite retry (ref live loader handleError)
                except Exception as e:  # bad data: drop batch, keep going
                    db.discard(txn)
                    with stats_lock:
                        stats["errors"] += 1
                    print(f"live: dropping batch of {len(nqs)} nquads: {e}",
                          file=sys.stderr)
                    break
        finally:
            with cv:
                inflight.difference_update(keys)
                cv.notify_all()
        if ok:
            with stats_lock:
                stats["txns"] += 1
                stats["nquads"] += len(nqs)

    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        futures = []
        for raw in batches():
            nqs = resolve(raw)
            keys = _conflict_keys(nqs)
            with cv:
                cv.wait_for(lambda: not (keys & inflight))
                inflight.update(keys)
            futures.append(pool.submit(run_batch, nqs, keys))
        for fut in futures:
            fut.result()
    return stats


def _is_uid_lit(ref: str) -> bool:
    try:
        int(ref, 0)
        return True
    except ValueError:
        return False


# ---------------------------------------------------------------------------
# remote mode: load into a RUNNING alpha over HTTP
# ---------------------------------------------------------------------------


def _render_nquad(nq: NQuad, xids: dict) -> str:
    """NQuad -> one RDF statement with blank nodes rewritten to their
    pre-allocated uids (every xid is assigned BEFORE rendering, so the
    output never contains `_:` terms)."""
    from dgraph_tpu_torch.ingest.export import _facet_str, _rdf_value

    def term(t: str) -> str:
        if t.startswith("_:") or not _is_uid_lit(t):
            return f"<{xids[t]:#x}>"
        return f"<{t}>"

    subj = term(nq.subject)
    if nq.star:
        obj = "*"
    elif nq.object_id:
        obj = term(nq.object_id)
    else:
        obj = _rdf_value(nq.object_value)
        if nq.lang:
            obj += f"@{nq.lang}"
    return f"{subj} <{nq.predicate}> {obj}{_facet_str(nq.facets)} ."


class _UidLease:
    """Client-side uid block lease over /assign (ref live/run.go
    allocateUids + zero assign): one HTTP round-trip hands out a block,
    xid->uid assignment is then a local dict insert."""

    def __init__(self, post, block: int = 10_000):
        self._post = post
        self._block = block
        self._next = 0
        self._end = -1
        self._xids: dict[str, int] = {}
        self._lock = threading.Lock()

    def resolve(self, xids_needed: set[str]) -> dict[str, int]:
        with self._lock:
            for x in sorted(xids_needed):
                if x in self._xids:
                    continue
                if self._next > self._end:
                    out = self._post(
                        f"/assign?num={self._block}", b"")
                    self._next = int(out["startId"])
                    self._end = int(out["endId"])
                self._xids[x] = self._next
                self._next += 1
            return self._xids


def remote_live_load(addr: str, paths: Iterable[str] = (), *,
                     schema: str = "", batch_size: int = DEFAULT_BATCH,
                     concurrency: int = DEFAULT_CONCURRENCY,
                     max_retries: int = 50, token: str = "",
                     timeout_s: float = 120.0) -> dict:
    """Stream files into a RUNNING alpha over HTTP — the reference live
    loader's defining mode (dgraph live --alpha, live/run.go:238):
    chunked parse, concurrent batches, abort (409) retry, and uid
    blocks pre-allocated via /assign so blank nodes are concrete uids
    before anything is sent — one xid is one node across batches and
    every batch runs fully parallel. Submission is windowed so a
    multi-GB file never materializes in memory."""
    import json as _json
    import urllib.error
    import urllib.request
    from collections import deque

    base = f"http://{addr}"

    def post(path: str, data: bytes,
             ctype: str = "application/rdf") -> dict:
        headers = {"Content-Type": ctype}
        if token:
            headers["X-Dgraph-AccessToken"] = token
        req = urllib.request.Request(base + path, data=data,
                                     headers=headers)
        return _json.loads(urllib.request.urlopen(
            req, timeout=timeout_s).read())

    if schema:
        post("/alter", schema.encode())

    lease = _UidLease(post)
    stats = {"nquads": 0, "txns": 0, "aborts": 0}
    stats_lock = threading.Lock()

    def send(nqs: list[NQuad]):
        needed = {t for nq in nqs
                  for t in (nq.subject, nq.object_id or "")
                  if t and (t.startswith("_:") or not _is_uid_lit(t))}
        xids = lease.resolve(needed)
        body = "\n".join(_render_nquad(nq, xids) for nq in nqs)
        for attempt in range(max_retries):
            try:
                post("/mutate?commitNow=true", body.encode())
            except urllib.error.HTTPError as e:
                if e.code == 409 and attempt + 1 < max_retries:
                    with stats_lock:
                        stats["aborts"] += 1
                    continue
                raise
            with stats_lock:
                stats["nquads"] += len(nqs)
                stats["txns"] += 1
            return
        raise RuntimeError("batch exhausted retries")

    def batches():
        for path in paths:
            for chunk in chunk_file(path):
                for i in range(0, len(chunk), batch_size):
                    yield chunk[i:i + batch_size]

    # windowed submission: at most ~4x concurrency batches in flight,
    # so parsing streams instead of materializing the whole file
    window = max(concurrency * 4, 4)
    inflight: deque = deque()
    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        for b in batches():
            inflight.append(pool.submit(send, b))
            while len(inflight) >= window:
                inflight.popleft().result()
        while inflight:
            inflight.popleft().result()
    return stats
