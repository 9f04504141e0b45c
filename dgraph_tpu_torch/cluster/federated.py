"""Federated query execution: one executor, tablets on many groups.

The reference executes every query as a task tree where each attr's
fetch routes to the group serving that attr (worker/task.go:131
ProcessTaskOverNetwork -> groups.go:378 BelongsTo). This module is that
capability for queries the block-wise scatter cannot serve: a SINGLE
block whose predicates live on different groups, or variables flowing
between blocks on different groups.

Design: the full (unchanged) query executor runs in the coordinating
process over a FederatedDB whose tablets are RemoteTablet proxies. A
proxy answers the Tablet read surface by batched "task" RPCs to the
predicate's owning group at one zero-issued global read_ts, caching
per query. Hot per-uid loops in the executor prefetch whole uid
batches (prefetch_edges / prefetch_postings), so one block level costs
one RPC per predicate — the same fan-out unit as the reference's
per-attr task messages.

Consistency: the read_ts is allocated by zero AFTER every commit it
must see; each group's first task pays a quorum read barrier
(leader-only + no-op round trip) and reconciles decided-but-unapplied
cross-group commits <= read_ts before answering.

Port of `dgraph_tpu/cluster/federated.py`: a copy, its imports pointed at
this package.
`FederatedDB(..., device=)` is built on the device of the coordinator
that builds it (`RoutedCluster(device=)`; None: the card). It keeps
the reference's host tiers (`prefer_device=False`): its tablets are
remote proxies, so it launches nothing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dgraph_tpu_torch.engine.db import GraphDB
from dgraph_tpu_torch.models.types import TypeID

_EMPTY = np.empty(0, dtype=np.uint64)


class RemoteTablet:
    """Tablet read-surface proxy over the owning group's task RPCs.
    Mirrors storage/tablet.py's read methods; caches per instance
    (instances live for one query, so caches are snapshot-consistent
    at read_ts)."""

    def __init__(self, fdb: "FederatedDB", pred: str, gid: int, schema,
                 expect_whole: bool = True):
        self._fdb = fdb
        self._gid = gid
        self.pred = pred
        self.schema = schema
        # True = this proxy believes `gid` serves the WHOLE predicate
        # (rides every task as `whole`): a group holding only a hash
        # range rejects such tasks typed, so a coordinator whose map
        # predates a split flip re-routes instead of silently reading
        # partial rows. SplitRemoteTablet's sub-proxies set False.
        self.expect_whole = expect_whole
        self._postings: dict[int, list] = {}
        self._edges: dict[tuple[int, bool], np.ndarray] = {}
        self._index: dict[bytes, np.ndarray] = {}
        self._counts: dict[tuple[int, bool], int] = {}
        self._facets: dict[tuple[int, int], dict] = {}
        self._src_uids: Optional[np.ndarray] = None
        self._dst_uids: Optional[np.ndarray] = None
        self._count_table = None
        self._sort_pairs = None

    # ------------------------------------------------------------- rpc

    def _task(self, kind: str, **args):
        return self._fdb._task(self._gid, dict(
            args, op="task", kind=kind, pred=self.pred,
            whole=self.expect_whole, read_ts=self._fdb.read_ts))

    @staticmethod
    def _u64(a) -> np.ndarray:
        return np.asarray(a, dtype=np.uint64)

    # ------------------------------------------------------- prefetch

    def prefetch_edges(self, uids, reverse: bool = False):
        miss = [int(u) for u in np.asarray(uids).tolist()
                if (int(u), reverse) not in self._edges]
        if not miss:
            return
        got = self._task("edges", uids=np.asarray(miss, np.uint64),
                         reverse=reverse)
        if got is None:  # tablet absent on its group: negative-cache
            got = [_EMPTY] * len(miss)
        for u, dsts in zip(miss, got):
            self._edges[(u, reverse)] = self._u64(dsts)

    def prefetch_postings(self, uids):
        miss = [int(u) for u in np.asarray(uids).tolist()
                if int(u) not in self._postings]
        if not miss:
            return
        got = self._task("postings",
                         uids=np.asarray(miss, np.uint64))
        if got is None:
            got = [[]] * len(miss)
        for u, ps in zip(miss, got):
            self._postings[u] = list(ps)

    def prefetch_counts(self, uids, reverse: bool = False):
        """Batch the per-uid fan-out counts for one block level into a
        single task RPC (ref worker/task.go per-attr task granularity;
        round-3 verdict: count(pred) over k uids paid k round trips)."""
        miss = [int(u) for u in np.asarray(uids).tolist()
                if (int(u), reverse) not in self._counts
                and not self._count_from_edges(int(u), reverse)]
        if not miss:
            return
        got = self._task("counts", uids=np.asarray(miss, np.uint64),
                         reverse=reverse)
        if got is None:
            got = [0] * len(miss)
        for u, c in zip(miss, got):
            self._counts[(u, reverse)] = int(c)

    def prefetch_facets(self, pairs):
        """Batch facet reads for a level's (src, dst) edge pairs into
        one task RPC."""
        miss = [(int(s), int(d)) for s, d in pairs
                if (int(s), int(d)) not in self._facets]
        if not miss:
            return
        got = self._task("facets", pairs=miss)
        if got is None:
            got = [{}] * len(miss)
        for key, fc in zip(miss, got):
            self._facets[key] = dict(fc)

    # ------------------------------------------------- tablet surface

    def get_dst_uids(self, src: int, read_ts: int) -> np.ndarray:
        key = (int(src), False)
        if key not in self._edges:
            self.prefetch_edges([src], reverse=False)
        return self._edges.get(key, _EMPTY)

    def get_reverse_uids(self, dst: int, read_ts: int) -> np.ndarray:
        key = (int(dst), True)
        if key not in self._edges:
            self.prefetch_edges([dst], reverse=True)
        return self._edges.get(key, _EMPTY)

    def get_postings(self, src: int, read_ts: int) -> list:
        if int(src) not in self._postings:
            self.prefetch_postings([src])
        return self._postings.get(int(src), [])

    def expand_frontier(self, frontier: np.ndarray, read_ts: int,
                        reverse: bool = False) -> np.ndarray:
        got = self._task("expand", uids=self._u64(frontier),
                         reverse=bool(reverse))
        return self._u64(got if got is not None else _EMPTY)

    def src_uids(self, read_ts: int) -> np.ndarray:
        if self._src_uids is None:
            got = self._task("src_uids")
            self._src_uids = self._u64(got) if got is not None \
                else _EMPTY.copy()
        return self._src_uids

    def dst_uids(self, read_ts: int) -> np.ndarray:
        if self._dst_uids is None:
            got = self._task("dst_uids")
            self._dst_uids = self._u64(got) if got is not None \
                else _EMPTY.copy()
        return self._dst_uids

    def index_uids(self, token: bytes, read_ts: int) -> np.ndarray:
        tok = bytes(token)
        if tok not in self._index:
            got = self._task("index", tokens=[tok])
            self._index[tok] = self._u64(got[0]) if got is not None \
                else _EMPTY.copy()
        return self._index[tok]

    def count_of(self, src: int, read_ts: int,
                 reverse: bool = False) -> int:
        return self._count(int(src), reverse=reverse)

    def _count_from_edges(self, uid: int, reverse: bool) -> bool:
        """Derive a UID-predicate count from an already-prefetched edge
        list instead of re-asking the group (the level's edges were
        shipped for expansion anyway; scalar tablets never enter the
        edge cache, so a hit here is always count-exact)."""
        dsts = self._edges.get((uid, reverse))
        if dsts is None or not self.schema.value_type == TypeID.UID:
            return False
        self._counts[(uid, reverse)] = len(dsts)
        return True

    def _count(self, uid: int, reverse: bool) -> int:
        key = (uid, reverse)
        if key not in self._counts and \
                not self._count_from_edges(uid, reverse):
            got = self._task("counts",
                             uids=np.asarray([uid], np.uint64),
                             reverse=reverse) or [0]
            self._counts[key] = int(got[0])
        return self._counts[key]

    def count_table(self):
        if self._count_table is None:
            got = self._task("count_table")
            if got is None:
                got = (_EMPTY, np.empty(0, np.int64))
            self._count_table = (self._u64(got[0]),
                                 np.asarray(got[1], np.int64))
        return self._count_table

    def get_facets(self, src: int, dst: int, read_ts: int) -> dict:
        key = (int(src), int(dst))
        if key not in self._facets:
            got = self._task("facets", pairs=[key]) or [{}]
            self._facets[key] = dict(got[0])
        return self._facets[key]

    def sort_key_pairs(self):
        if self._sort_pairs is None:
            got = self._task("sort_key_pairs") or {}
            self._sort_pairs = {int(k): int(v) for k, v in got.items()}
        return self._sort_pairs

    def dirty(self) -> bool:
        # the serving group answers reads through its own MVCC overlay;
        # the proxy never sees raw overlay state
        return False

    def overlay_srcs(self, read_ts: int, reverse: bool = False):
        return ()


class SplitRemoteTablet:
    """Read surface of a hash-range SPLIT predicate: one RemoteTablet
    per owning group, per-uid calls routed by subject hash
    (cluster/shard.py — each row lives on exactly one sub-tablet),
    set-valued calls fanned to every owner and UNIONED (token-index
    probes, src/dst uid sets, reverse lookups: sub-tablets index only
    their own rows, so the union is exact and disjointness makes it
    cheap). This is the piece that lets the unchanged executor run
    over a split predicate as if it were whole."""

    def __init__(self, fdb: "FederatedDB", pred: str,
                 owners: list[int], schema):
        self.pred = pred
        self.schema = schema
        self._owners = [int(g) for g in owners]
        # one proxy per DISTINCT group (a group owning two shards
        # serves both from its single local tablet); sub-proxies
        # EXPECT partial copies (expect_whole=False)
        self._subs = {gid: RemoteTablet(fdb, pred, gid, schema,
                                        expect_whole=False)
                      for gid in sorted(set(self._owners))}

    def _sub_for(self, uid: int) -> RemoteTablet:
        from dgraph_tpu_torch.cluster.shard import shard_of
        return self._subs[
            self._owners[shard_of(int(uid), len(self._owners))]]

    def _route_uids(self, uids) -> dict:
        """Partition a uid batch by owning group — vectorized
        (shard_mask is numpy splitmix64): a viral predicate's
        frontier is exactly where a per-uid Python hash loop would
        dominate the coordinator."""
        from dgraph_tpu_torch.cluster.shard import shard_mask
        arr = np.asarray(uids, np.uint64)
        n = len(self._owners)
        out: dict[int, np.ndarray] = {}
        for shard, gid in enumerate(self._owners):
            part = arr[shard_mask(arr, n, shard)]
            if len(part):
                prev = out.get(gid)
                out[gid] = part if prev is None \
                    else np.concatenate([prev, part])
        return out

    @staticmethod
    def _union(parts: list[np.ndarray]) -> np.ndarray:
        parts = [p for p in parts if len(p)]
        if not parts:
            return _EMPTY
        out = parts[0]
        for p in parts[1:]:
            out = np.union1d(out, p)
        return np.asarray(out, np.uint64)

    def _owned(self, gid: int, uids) -> np.ndarray:
        """Keep only SUBJECT uids whose shard `gid` OWNS per the
        routing map. Every union-shaped read filters each group's
        answer through this: in the flip->prune window the source
        still physically holds the moved range (frozen at the fence
        watermark — post-flip writes land on the destination), so an
        unfiltered union would resurface overwritten values and
        deleted edges from the stale copy. Ownership-filtering makes
        the union exact regardless of prune timing."""
        from dgraph_tpu_torch.cluster.shard import shard_mask
        arr = np.asarray(uids, np.uint64)
        if not len(arr):
            return arr
        n = len(self._owners)
        keep = np.zeros(len(arr), bool)
        for shard, g in enumerate(self._owners):
            if g == gid:
                keep |= shard_mask(arr, n, shard)
        return arr[keep]

    # ------------------------------------------------- prefetch (by uid)

    def prefetch_edges(self, uids, reverse: bool = False):
        if reverse:
            return  # reverse lookups fan out per call (see below)
        for gid, us in self._route_uids(uids).items():
            self._subs[gid].prefetch_edges(us, reverse=False)

    def prefetch_postings(self, uids):
        for gid, us in self._route_uids(uids).items():
            self._subs[gid].prefetch_postings(us)

    def prefetch_counts(self, uids, reverse: bool = False):
        if reverse:
            return
        for gid, us in self._route_uids(uids).items():
            self._subs[gid].prefetch_counts(us, reverse=False)

    def prefetch_facets(self, pairs):
        by: dict[int, list] = {}
        from dgraph_tpu_torch.cluster.shard import shard_of
        for s, d in pairs:
            gid = self._owners[shard_of(int(s), len(self._owners))]
            by.setdefault(gid, []).append((int(s), int(d)))
        for gid, ps in by.items():
            self._subs[gid].prefetch_facets(ps)

    # ------------------------------------------------- tablet surface

    def get_dst_uids(self, src: int, read_ts: int) -> np.ndarray:
        return self._sub_for(src).get_dst_uids(src, read_ts)

    def get_reverse_uids(self, dst: int, read_ts: int) -> np.ndarray:
        # the edges POINTING AT dst may originate in any shard: fan
        # out and union, each group's answer filtered to the SUBJECT
        # shards it owns
        return self._union(
            [self._owned(g, t.get_reverse_uids(dst, read_ts))
             for g, t in self._subs.items()])

    def get_postings(self, src: int, read_ts: int) -> list:
        return self._sub_for(src).get_postings(src, read_ts)

    def expand_frontier(self, frontier: np.ndarray, read_ts: int,
                        reverse: bool = False) -> np.ndarray:
        if reverse:
            # reverse expansion returns SUBJECT uids: filter each
            # group's answer to its owned shards before the union
            return self._union(
                [self._owned(g, t.expand_frontier(frontier, read_ts,
                                                  True))
                 for g, t in self._subs.items()])
        parts = []
        for gid, us in self._route_uids(frontier).items():
            parts.append(self._subs[gid].expand_frontier(
                np.asarray(us, np.uint64), read_ts, False))
        return self._union(parts)

    def src_uids(self, read_ts: int) -> np.ndarray:
        return self._union([self._owned(g, t.src_uids(read_ts))
                            for g, t in self._subs.items()])

    def dst_uids(self, read_ts: int) -> np.ndarray:
        # OBJECT uids are not shard-partitioned, so ownership cannot
        # filter here; the union dedupes, and the residual exposure
        # (a dst whose last in-edge was deleted post-flip lingering
        # until the source prunes) is bounded by the prune delivery
        return self._union([t.dst_uids(read_ts)
                            for t in self._subs.values()])

    def index_uids(self, token: bytes, read_ts: int) -> np.ndarray:
        return self._union(
            [self._owned(g, t.index_uids(token, read_ts))
             for g, t in self._subs.items()])

    def count_of(self, src: int, read_ts: int,
                 reverse: bool = False) -> int:
        if reverse:
            # count the UNION, not the sum of counts: in the short
            # flip->prune window both groups still hold the moved
            # range's rows and a raw sum would double-count
            return len(self.get_reverse_uids(src, read_ts))
        return self._sub_for(src).count_of(src, read_ts)

    def count_table(self):
        srcs, cnts = [], []
        for g, t in self._subs.items():
            s, c = t.count_table()
            s = np.asarray(s, np.uint64)
            # ownership-filter each group's rows (see _owned): the
            # unpruned source's moved-range rows are stale the moment
            # a post-flip write lands on the destination
            keep = np.isin(s, self._owned(g, s))
            srcs.append(s[keep])
            cnts.append(np.asarray(c, np.int64)[keep])
        s = np.concatenate(srcs) if srcs else _EMPTY
        c = np.concatenate(cnts) if cnts else np.empty(0, np.int64)
        order = np.argsort(s, kind="stable")  # disjoint by ownership
        return s[order], c[order]

    def sort_key_pairs(self):
        out: dict[int, int] = {}
        for g, t in self._subs.items():
            pairs = t.sort_key_pairs()
            owned = set(self._owned(
                g, np.fromiter(pairs, np.uint64,
                               len(pairs))).tolist())
            out.update((u, v) for u, v in pairs.items()
                       if int(u) in owned)
        return out

    def get_facets(self, src: int, dst: int, read_ts: int) -> dict:
        return self._sub_for(src).get_facets(src, dst, read_ts)

    def dirty(self) -> bool:
        return False

    def overlay_srcs(self, read_ts: int, reverse: bool = False):
        return ()


class _RemoteTablets(dict):
    """Lazy pred -> RemoteTablet mapping over the cluster tablet map
    (+ SplitRemoteTablet fan-outs for hash-range split predicates)."""

    def __init__(self, fdb: "FederatedDB", tmap: dict[str, int],
                 splits: Optional[dict] = None):
        super().__init__()
        self._fdb = fdb
        self._tmap = dict(tmap)
        self._splits = dict(splits or {})

    def get(self, pred, default=None):
        tab = dict.get(self, pred)
        if tab is not None:
            return tab
        ent = self._splits.get(pred)
        if ent is not None:
            tab = SplitRemoteTablet(
                self._fdb, pred, ent["owners"],
                self._fdb.schema.get_or_default(pred))
            self[pred] = tab
            return tab
        gid = self._tmap.get(pred)
        if gid is None:
            return default
        tab = RemoteTablet(self._fdb, pred, gid,
                           self._fdb.schema.get_or_default(pred))
        self[pred] = tab
        return tab

    def __contains__(self, pred):
        return dict.__contains__(self, pred) or pred in self._tmap \
            or pred in self._splits


class FederatedDB(GraphDB):
    """GraphDB whose tablets live on remote groups. query() is the
    inherited engine path (parse -> Executor -> emission) — only the
    tablet fetches go remote, exactly the reference's split between
    query planning and per-attr worker tasks."""

    def __init__(self, groups: dict[int, object], tmap: dict[str, int],
                 schema_text: str, read_ts: int, ctx=None,
                 splits: Optional[dict] = None, device=None):
        super().__init__(prefer_device=False, device=device)
        self._groups = groups
        self.read_ts = read_ts
        # coordinator-side RequestContext: every task RPC checks it
        # and ships the REMAINING budget as deadline_ms so the owning
        # group inherits the deadline (plus a small skew allowance on
        # its side) — the reference forwards its context on every
        # worker RPC (worker/task.go ProcessTaskOverNetwork)
        self.req_ctx = ctx
        if schema_text:
            self.schema.apply_text(schema_text)
        self.tablets = _RemoteTablets(self, tmap, splits=splits)

    def _task(self, gid: int, req: dict):
        # the serving node pays the quorum read barrier on every task
        # (a cached client-side barrier would go stale on a mid-query
        # leader change), so there is nothing to track here
        deadline_s = None
        if self.req_ctx is not None:
            self.req_ctx.check(f"task on group {gid}")
            rem = self.req_ctx.remaining_ms()
            if rem is not None:
                req = dict(req, deadline_ms=rem,
                           trace_id=self.req_ctx.trace_id)
                # the budget also bounds the CLIENT-side wait: an
                # election on the owning group must not hold an
                # expired coordinator for the full default timeout
                deadline_s = rem / 1000.0
        cl = self._groups[gid]
        resp = cl.request(req, deadline_s=deadline_s)
        if not resp.get("ok"):
            if self.req_ctx is not None:
                # a budget that ran out DURING the RPC must surface as
                # DeadlineExceeded (-> 408, retryable), not as a
                # generic task failure (-> 500)
                self.req_ctx.check(f"task on group {gid}")
            if resp.get("misrouted"):
                # the tablet flipped away mid-query: typed, so the
                # router re-fetches its map and re-runs the query
                from dgraph_tpu_torch.cluster.errors import TabletMisrouted
                m = resp["misrouted"]
                raise TabletMisrouted(m.get("pred", "?"),
                                      m.get("group"),
                                      resp.get("error", ""))
            raise RuntimeError(
                f"task {req.get('kind')} on group {gid} failed: "
                f"{resp.get('error')}")
        return resp["result"]

    def query(self, q: str, variables: dict | None = None, **kw):
        kw.setdefault("read_ts", self.read_ts)
        kw.setdefault("ctx", self.req_ctx)
        return super().query(q, variables, **kw)
