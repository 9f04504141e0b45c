"""Offline bulk loader: map → shuffle → reduce into tablet base state.

Re-provides dgraph/cmd/bulk/ semantics with a vectorized reduce:

  reference: mappers emit sorted pb.MapEntry runs per predicate-shard
             (mapper.go:137), reducers k-way-heap-merge them
             (reduce.go:290 postingHeap) into posting lists written as
             Badger SSTs at a fixed writeTs.
  here:      mappers emit flat (src, dst) uid arrays + value posting
             lists per predicate; the reduce is ONE vectorized
             lexsort + boundary-diff per predicate (the device-friendly
             "segmented sort + unique" replacing the heap merge), then
             tablets are constructed directly in base state and the
             index/reverse maps are (re)built.

Everything lands at a single fixed write_ts, exactly like the
reference's fixed writeTs (bulk/loader.go getWriteTimestamp).

Port of `dgraph_tpu/ingest/bulk.py`. RDF maps through the host
runtime's columnar parser (`native.rdf_parse`), as in the reference;
with the runtime switched off it maps through the Python grammar, which
gives the same tablets. Tablets are built on the engine's device
(`bulk_load(device=...)` for a fresh engine; None: the card).
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterable, Iterator, Optional

import numpy as np

from dgraph_tpu_torch.engine.db import GraphDB
from dgraph_tpu_torch.gql.nquad import (
    _XS_TYPES, _coerce, _unescape, NQuad, parse_facet_text, parse_rdf,
)
from dgraph_tpu_torch.ingest.chunker import _open, chunk_file, detect_format
from dgraph_tpu_torch.ingest.xidmap import XidMap
from dgraph_tpu_torch.models.schema import PredicateSchema
from dgraph_tpu_torch.models.types import TypeID, Val, convert
from dgraph_tpu_torch.storage.tablet import Posting, Tablet
from dgraph_tpu_torch.wire import dumps as wire_dumps
from dgraph_tpu_torch.wire import loads as wire_loads

_SPILL_BYTES = 256 << 20  # mapper buffer flush threshold: approx
# RESIDENT bytes pending across all shards. Byte-based, not
# edge-count: a float32vector posting costs its payload's real size
# (dim * 4 + object overhead), not "one edge" — counting rows
# undercounted vector-heavy inputs by two orders of magnitude and
# blew past the intended memory ceiling. Costs approximate RESIDENT
# python-object sizes (boxed ints, Posting/Val shells), because that
# is what actually fills the mapper's RAM between spills (review
# finding: packed-byte costs undercounted object buffers ~6x).

# python-path edge buffers are LISTS OF INT OBJECTS, not packed
# arrays: two list slots + two boxed ints resident per edge
_EDGE_COST = 72


def _posting_cost(p: Posting) -> int:
    """Approximate RESIDENT bytes of one buffered value posting — the
    spill accountant's unit. The Posting+Val shells cost ~112 B of
    headers/slots; vectors add their exact payload nbytes, strings
    their length; scalars are boxed small objects."""
    v = p.value.value
    if isinstance(v, np.ndarray):
        return 112 + int(v.nbytes)
    if isinstance(v, (str, bytes)):
        return 112 + len(v)
    return 120


class _MapShard:
    """Per-predicate mapper accumulator with disk spill.  Edge uids
    arrive either one at a time (python grammar path: `src`/`dst`
    lists) or as whole per-chunk arrays from the native parser
    (`src_arrs`/`dst_arrs`) — the reduce concatenates both."""

    def __init__(self, tmpdir: str, pred: str):
        self.pred = pred
        self.tmpdir = tmpdir
        self.src: list[int] = []
        self.dst: list[int] = []
        self.src_arrs: list[np.ndarray] = []
        self.dst_arrs: list[np.ndarray] = []
        self.vals: list[tuple[int, Posting]] = []
        self.facets: list[tuple[int, int, dict]] = []
        self.runs: list[str] = []

    def _edge_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        srcs = self.src_arrs + [np.asarray(self.src, np.uint64)]
        dsts = self.dst_arrs + [np.asarray(self.dst, np.uint64)]
        return np.concatenate(srcs), np.concatenate(dsts)

    def spill(self):
        if not (self.src or self.src_arrs or self.vals):
            return
        path = os.path.join(
            self.tmpdir, f"map-{len(self.runs)}-{abs(hash(self.pred))}.run")
        srcs, dsts = self._edge_arrays()
        with open(path, "wb") as f:
            f.write(wire_dumps((srcs, dsts, self.vals, self.facets)))
        self.runs.append(path)
        self.src, self.dst, self.vals, self.facets = [], [], [], []
        self.src_arrs, self.dst_arrs = [], []

    def load_all(self):
        """Concatenated (src, dst, vals, facets) over all runs + buffer."""
        s0, d0 = self._edge_arrays()
        srcs, dsts = [s0], [d0]
        vals = list(self.vals)
        facets = list(self.facets)
        for path in self.runs:
            with open(path, "rb") as f:
                s, d, v, fc = wire_loads(f.read())
            srcs.append(s)
            dsts.append(d)
            vals.extend(v)
            facets.extend(fc)
        return np.concatenate(srcs), np.concatenate(dsts), vals, facets


def bulk_load(paths: Iterable[str] = (), *,
              nquads: Optional[Iterator[list[NQuad]]] = None,
              schema: str = "", db: Optional[GraphDB] = None,
              tmpdir: str | None = None, device=None) -> GraphDB:
    """Build a GraphDB offline from RDF/JSON files and/or NQuad batches
    (into `db`, or a fresh engine on `device`, None: the card).
    Ref: dgraph/cmd/bulk/run.go:106 + loader.go mapStage/reduceStage."""
    db = db or GraphDB(device=device)
    if schema:
        db.alter(schema)
    # Millions of small Posting/Val objects make cyclic-GC gen2 scans
    # the dominant nonlinearity at the 21M regime (the object graph
    # here is acyclic); the reference tunes GC for bulk the same way
    # (dgraph/main.go GC percent ticker).
    import gc
    gc_was = gc.isenabled()
    gc.disable()
    try:
        return _bulk_load_locked(paths, nquads, db, tmpdir)
    finally:
        if gc_was:
            gc.enable()


def _bulk_load_locked(paths, nquads, db, tmpdir) -> GraphDB:
    own_tmp = tmpdir is None
    tmpdir = tmpdir or tempfile.mkdtemp(prefix="dg-bulk-")
    xidmap = XidMap(db.coordinator)
    shards: dict[str, _MapShard] = {}
    pending_bytes = 0

    def shard(pred: str) -> _MapShard:
        s = shards.get(pred)
        if s is None:
            s = _MapShard(tmpdir, pred)
            shards[pred] = s
        return s

    # -- map stage (ref bulk/mapper.go:207 processNQuad) --
    # explicit-uid high-water mark: the coordinator must know the max
    # BEFORE any later blank-node lease is cut (a deferred end-of-batch
    # bump would let a lease block collide with an explicit uid seen
    # earlier in the same batch — review finding), but most statements
    # don't raise the max, so the lock is taken only on a new high
    bumped = 0

    def resolve(ref: str) -> int:
        uid = _resolve(xidmap, ref)
        bump_to(uid)
        return uid

    def bump_to(uid: int):
        nonlocal bumped
        if uid > bumped:
            xidmap.coordinator.bump_uids(uid)
            bumped = uid

    def add_nq(nq: NQuad):
        # the HOT path: accumulate an approximate packed-byte cost
        # only — the spill threshold check is hoisted to the per-chunk
        # maybe_spill so adds stay one append + one integer bump
        nonlocal pending_bytes
        src = resolve(nq.subject)
        s = shard(nq.predicate)
        if nq.object_id:
            dst = resolve(nq.object_id)
            s.src.append(src)
            s.dst.append(dst)
            if nq.facets:
                s.facets.append((src, dst, nq.facets))
            pending_bytes += _EDGE_COST
        elif nq.object_value is not None:
            p = Posting(nq.object_value, nq.lang, nq.facets)
            s.vals.append((src, p))
            pending_bytes += _posting_cost(p)

    def maybe_spill():
        # batched per map chunk (never per nquad): one threshold
        # check per chunk against the byte-accurate pending total
        nonlocal pending_bytes
        if pending_bytes >= _SPILL_BYTES:
            for s in shards.values():
                s.spill()
            pending_bytes = 0

    from dgraph_tpu_torch import native as _native
    for p in paths:
        fmt = detect_format(p)
        if fmt == "rdf" and _native.available():
            # columnar fast path: the native parser returns whole
            # uid/literal row arrays per chunk; only lines outside its
            # grammar go through the python parser (bit-identical —
            # tested against parse_rdf on the same input)
            for text in _raw_text_chunks(p):
                pending_bytes += _map_native_chunk(
                    text, shard, add_nq, bump_to)
                maybe_spill()
        else:
            for batch in chunk_file(p, fmt):
                for nq in batch:
                    add_nq(nq)
                maybe_spill()
    if nquads is not None:
        for batch in nquads:
            for nq in batch:
                add_nq(nq)
            maybe_spill()

    # -- reduce stage (ref bulk/reduce.go:50) --
    write_ts = db.coordinator.next_ts()
    for pred, s in shards.items():
        srcs, dsts, vals, facets = s.load_all()
        reduce_predicate(db, pred, srcs, dsts, vals,
                         [(fs, fd, fc) for fs, fd, fc in facets],
                         write_ts)
        if db.tablet_store is not None:
            # disk-backed load: each predicate offloads to the LSM
            # store as its reduce finishes, so the dataset never has
            # to fit in RAM (ref bulk/reduce.go writing SSTs per
            # predicate shard)
            db.tablets.offload(pred)
    if own_tmp:
        for s in shards.values():
            for r in s.runs:
                os.unlink(r)
        try:
            os.rmdir(tmpdir)
        except OSError:
            pass
    return db


def reduce_predicate(db: GraphDB, pred: str, srcs, dsts,
                     vals, facets, write_ts: int):
    """One predicate's reduce into base tablet state — the single
    reduce kernel shared by the single-core loader above and the
    per-group distributed reducers (ingest/distributed.py), so the two
    paths produce identical tablets from identical inputs by
    construction. `vals`/`facets` must arrive in FILE ORDER (the
    distributed shuffle tags them with (chunk, idx) and sorts before
    calling here): value-list merge semantics are order-dependent."""
    tab = _tablet_for_bulk(db, pred, srcs, vals)
    if len(srcs):
        # segmented sort + unique: one lexsort replaces the k-way heap
        order = np.lexsort((dsts, srcs))
        srcs, dsts = srcs[order], dsts[order]
        keep = np.ones(len(srcs), bool)
        keep[1:] = (srcs[1:] != srcs[:-1]) | (dsts[1:] != dsts[:-1])
        srcs, dsts = srcs[keep], dsts[keep]
        bounds = np.nonzero(np.r_[True, srcs[1:] != srcs[:-1]])[0]
        ends = np.r_[bounds[1:], len(srcs)]
        for b, e in zip(bounds.tolist(), ends.tolist()):
            src = int(srcs[b])
            old = tab.edges.get(src)
            tab.edges[src] = dsts[b:e].copy() if old is None \
                else np.union1d(old, dsts[b:e])
        for fsrc, fdst, fc in facets:
            tab.edge_facets[(fsrc, fdst)] = fc
    for src, posting in vals:
        if tab.schema.value_type not in (TypeID.DEFAULT,):
            posting = Posting(
                convert(posting.value, tab.schema.value_type),
                posting.lang, posting.facets)
        tab.merge_base_value(src, posting)
    tab.base_ts = write_ts
    tab.rebuild_index()
    tab.rebuild_reverse()
    db.coordinator.should_serve(pred)
    # CDC floor at the bulk write_ts: base state is not change
    # history — a subscriber from offset 0 must re-sync via a
    # snapshot read, never silently skip the bulk data
    db.cdc.reset_floor(pred, write_ts)
    return tab


def bulk_shard_outputs(db: GraphDB, n_groups: int, outdir: str) -> dict:
    """Shard a bulk-loaded store into one bootable snapshot per future
    Alpha group (ref bulk/reduce.go:50 writing out/<i>/p per reduce
    shard + merge_shards.go:34): size-balanced greedy predicate
    partition, `g<k>/p.snap` per group, and a manifest recording the
    tablet map plus the ts/uid watermarks the cluster's Zero must
    honor (alphas push them via the bump_maxes op at boot).

    Every group snapshot carries the FULL schema — the cluster
    replicates schema text everywhere (topology.alter), only tablets
    are sharded."""
    import json

    from dgraph_tpu_torch.storage.snapshot import save_snapshot

    preds = sorted(db.tablets)
    sizes = {p: db.tablets[p].approx_bytes() for p in preds}
    assign: dict[int, list[str]] = {g: [] for g in range(1, n_groups + 1)}
    load: dict[int, int] = {g: 0 for g in assign}
    for p in sorted(preds, key=lambda p: (-sizes[p], p)):
        g = min(sorted(load), key=lambda k: load[k])
        assign[g].append(p)
        load[g] += sizes[p]
    os.makedirs(outdir, exist_ok=True)
    tmap: dict[str, int] = {}
    for g, ps in assign.items():
        sub = GraphDB(prefer_device=False, device=db.device)
        sub.schema = db.schema
        sub.coordinator = db.coordinator
        for p in ps:
            sub.tablets[p] = db.tablets[p]
            tmap[p] = g
        gdir = os.path.join(outdir, f"g{g}")
        os.makedirs(gdir, exist_ok=True)
        save_snapshot(sub, os.path.join(gdir, "p.snap"))
    manifest = {
        "groups": {str(g): sorted(ps) for g, ps in assign.items()},
        "tablets": tmap,
        "max_ts": db.coordinator.max_assigned(),
        "next_uid": db.coordinator._next_uid,
    }
    with open(os.path.join(outdir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


_NOID = (1 << 64) - 1  # native parser's "no lang/dtype" sentinel


def _raw_text_chunks(path: str, chunk_bytes: int = 8 << 20):
    """Raw text blocks split at line boundaries (gzip transparent) —
    the native parser's input unit and distributed ingest's chunk
    unit."""
    with _open(path) as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                return
            tail = f.readline()
            yield block + (tail or "")


def _map_native_chunk(text: str, shard, add_nq, bump_to) -> int:
    """One text chunk through native.rdf_parse: edge rows land as
    arrays grouped by predicate, literal rows build Postings directly,
    fallback lines replay through the exact python grammar (ref
    bulk/mapper.go:207 processNQuad, chunker/rdf_parser.go:58).
    Returns the approximate PACKED BYTES buffered (the spill
    accountant's unit; fallback lines self-count through add_nq)."""
    from dgraph_tpu_torch import native

    data = text.encode("utf-8")
    parsed = native.rdf_parse(data)
    if parsed is None:
        for nq in parse_rdf(text):
            add_nq(nq)
        return 0
    e_subj, e_pred, e_dst, e_fs, e_fl = parsed.edges
    (v_subj, v_pred, v_ls, v_ll, v_flags,
     v_lang, v_dtype, v_fs, v_fl) = parsed.vals
    # uid high-water BEFORE any fallback blank-node lease is cut
    hi = 0
    if len(e_subj):
        hi = max(int(e_subj.max()), int(e_dst.max()))
    if len(v_subj):
        hi = max(hi, int(v_subj.max()))
    if hi:
        bump_to(hi)
    preds = parsed.preds
    n = 0
    if len(e_subj):
        order = np.argsort(e_pred, kind="stable")
        ep = e_pred[order]
        bounds = np.nonzero(np.r_[True, ep[1:] != ep[:-1]])[0]
        ends = np.r_[bounds[1:], len(ep)]
        for b, e in zip(bounds.tolist(), ends.tolist()):
            grp = order[b:e]
            s = shard(preds[int(ep[b])])
            s.src_arrs.append(e_subj[grp])
            s.dst_arrs.append(e_dst[grp])
        for i in np.nonzero(e_fl)[0].tolist():
            fc = parse_facet_text(
                data[int(e_fs[i]):int(e_fs[i] + e_fl[i])].decode())
            if fc:  # `( )` parses empty; python's `if nq.facets` skips
                shard(preds[int(e_pred[i])]).facets.append(
                    (int(e_subj[i]), int(e_dst[i]), fc))
        n += int(e_subj.nbytes) + int(e_dst.nbytes)
    if len(v_subj):
        langs, dtypes = parsed.langs, parsed.dtypes
        for subj, pid, ls, ll, fl, lg, dt, fs, flen in zip(
                v_subj.tolist(), v_pred.tolist(), v_ls.tolist(),
                v_ll.tolist(), v_flags.tolist(), v_lang.tolist(),
                v_dtype.tolist(), v_fs.tolist(), v_fl.tolist()):
            sval = data[ls:ls + ll].decode("utf-8")
            if fl & 1:
                sval = _unescape(sval)
            if dt != _NOID:
                dtype = dtypes[dt]
                tid = _XS_TYPES.get(
                    dtype.split("#")[-1] if "#" in dtype else dtype)
                val = _coerce(sval,
                              TypeID.STRING if tid is None else tid)
            else:
                val = Val(TypeID.DEFAULT, sval)
            facets = parse_facet_text(
                data[fs:fs + flen].decode("utf-8")) if flen else {}
            p = Posting(val, langs[lg] if lg != _NOID else "", facets)
            shard(preds[pid]).vals.append((subj, p))
            n += _posting_cost(p)
    fb_s, fb_l = parsed.fallback
    if len(fb_s):
        txt = "\n".join(
            data[int(a):int(a + b)].decode("utf-8")
            for a, b in zip(fb_s.tolist(), fb_l.tolist()))
        for nq in parse_rdf(txt):
            add_nq(nq)
    return n


def _resolve(xidmap: XidMap, ref: str) -> int:
    """Explicit uids are NOT bumped here — the map loop tracks the
    batch max and bumps the lease counter once per batch."""
    if ref.startswith("_:"):
        return xidmap.assign(ref)
    try:
        return int(ref, 0)
    except ValueError:
        return xidmap.assign(ref)  # external xid


def _tablet_for_bulk(db: GraphDB, pred: str, srcs, vals) -> Tablet:
    tab = db.tablets.get(pred)
    if tab is not None:
        return tab
    ps = db.schema.get(pred)
    if ps is None:
        if len(srcs) and not vals:
            tid = TypeID.UID
        elif vals:
            tid = vals[0][1].value.tid
            if tid not in (TypeID.INT, TypeID.FLOAT, TypeID.BOOL,
                           TypeID.DATETIME, TypeID.GEO,
                           TypeID.FLOAT32VECTOR):
                tid = TypeID.DEFAULT
        else:
            tid = TypeID.DEFAULT
        ps = PredicateSchema(pred, value_type=tid)
        db.schema.set_predicate(ps)
    tab = Tablet(pred, ps, device=db.device)
    db.tablets[pred] = tab
    return tab
