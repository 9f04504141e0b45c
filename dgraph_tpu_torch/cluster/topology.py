"""Multi-group topology: predicate-sharded groups behind one client.

The reference shards data by PREDICATE across Alpha groups: Zero owns
the tablet->group map (zero/tablet.go), alphas serve only their
tablets, queries/mutations route per predicate (worker/groups.go
BelongsTo, worker/task.go:131 attr routing), and the rebalancer moves
tablets between groups (zero/tablet.go:62 movetablet,
worker/predicate_move.go). RoutedCluster is that tier's client side:
it consults the replicated Zero quorum for ownership, claims unowned
predicates on first write (least-loaded group), refuses writes to
tablets mid-move, and orchestrates live tablet moves
(export -> import -> flip -> drop).

Cross-group contract (all three tiers, fastest first):
  1. every predicate on one group -> route the whole request there;
  2. top-level blocks on different groups -> scatter block-wise at one
     global read_ts and gather;
  3. a single block spanning groups, or variables crossing groups ->
     FEDERATED execution (cluster/federated.py): the unchanged query
     executor runs here with per-attr task RPCs to each owning group
     (ref worker/task.go:131 ProcessTaskOverNetwork).
Mutations spanning groups run as one atomic transaction: per-group
replicated stages + a single commit decision recorded in the Zero
oracle (2PC; ref worker/mutation.go:472, zero/oracle.go:326).

Port of `dgraph_tpu/cluster/topology.py`: a copy, its imports pointed at
this package.
`RoutedCluster(device=)` is the device its federated coordinator
(`FederatedDB`) is built on (None: the card).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from dgraph_tpu_torch.cluster.client import ClusterClient
from dgraph_tpu_torch.cluster.errors import StaleRead, TabletMisrouted


class SpanGroupsError(RuntimeError):
    """A request's predicates resolve to more than one group — the
    signal (internal to this module) that the cross-group path must
    run: block-wise scatter, federated execution, or a 2PC mutation."""

    def __init__(self, preds, owners):
        super().__init__(
            f"predicates {sorted(preds)} span groups {sorted(owners)}")
        self.preds = preds
        self.owners = owners


class _NeedsFederation(Exception):
    """Block-wise scatter can't serve this query (a single block spans
    groups, or a variable crosses groups): run it federated."""


class RoutedCluster:
    def __init__(self, zero: ClusterClient,
                 groups: dict[int, ClusterClient], device=None):
        self.zero = zero
        self.groups = dict(groups)
        # the federated coordinator's engine device (None: the card)
        self.device = device
        # read scale-out state: per-group read pools spanning voters
        # AND learners, refreshed from zero's membership so a learner
        # joining mid-run starts taking reads without a client restart
        # (the reference's StreamMembership push, realized as a
        # bounded-staleness pull); `groups` itself stays voters-only —
        # writes and pinned reads never land on a learner
        self._read_pools: dict[int, dict] = {}
        self._read_lock = threading.Lock()
        self._rr = 0
        self._read_ts_grant: tuple[int, float] = (0, -1.0)

    # ------------------------------------------------------------- routing

    def tablet_map(self) -> dict:
        resp = self.zero.request({"op": "tablet_map"})
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "zero unreachable"))
        return resp["result"]

    def _preds_of_query(self, q: str, variables=None) -> set[str]:
        from dgraph_tpu_torch.gql import parse
        from dgraph_tpu_torch.server.acl import query_predicates
        return {p.lstrip("~") for p in
                query_predicates(parse(q, variables))}

    def _preds_of_mutation(self, kw: dict) -> set[str]:
        from dgraph_tpu_torch.server.acl import (
            nquad_predicates, query_predicates,
        )
        preds = set(nquad_predicates(
            kw.get("set_nquads", ""), kw.get("del_nquads", ""),
            kw.get("set_json"), kw.get("delete_json")))
        if kw.get("query"):
            from dgraph_tpu_torch.gql import parse
            preds |= set(query_predicates(
                parse(kw["query"], kw.get("variables"))))
        return {p.lstrip("~") for p in preds if p != "*"}

    def _group_for(self, preds: set[str], claim: bool,
                   tmap: Optional[dict] = None,
                   for_write: bool = False) -> int:
        """Resolve the single group serving `preds`; with claim=True,
        unowned predicates are claimed for the chosen group (ref
        zero.go ShouldServe: first writer claims the tablet).

        Only WRITES respect the moving fence (the move machine's
        short `fenced` phase) — reads never fence: the source keeps
        serving snapshot-consistent reads through every move phase
        until the flip, and post-flip routing points at the
        destination. A hash-range split predicate always has multiple
        owners, so it routes through the cross-group paths."""
        if tmap is None:
            tmap = self.tablet_map()
        if for_write:
            moving = tmap["moving"]
            for p in preds:
                if p in moving:
                    raise RuntimeError(
                        f"tablet {p!r} is being moved; retry shortly")
        splits = tmap.get("splits", {})
        owners = {tmap["tablets"][p] for p in preds
                  if p in tmap["tablets"]}
        for p in preds:
            if p in splits:
                owners.update(int(g) for g in splits[p]["owners"])
        if len(owners) > 1:
            raise SpanGroupsError(preds, owners)
        unowned = [p for p in preds if p not in tmap["tablets"]
                   and p not in splits]
        if owners:
            gid = owners.pop()
        elif not unowned:
            gid = min(self.groups)  # no predicates at all (uid-only)
        else:
            # least-loaded group by tablet count (the rebalancer's
            # heuristic inverted: place new tablets where it's empty)
            counts = {g: 0 for g in self.groups}
            for owner in tmap["tablets"].values():
                if owner in counts:
                    counts[owner] += 1
            gid = min(sorted(counts), key=lambda g: counts[g])
        if claim:
            for p in unowned:
                got = self.zero.tablet(p, gid)
                if got != gid:
                    raise RuntimeError(
                        f"tablet {p!r} was claimed by group {got} "
                        "concurrently; retry")
        return gid

    # ------------------------------------------------------------- surface

    def alter(self, schema_text: str = "", **kw):
        """Schema is cluster-wide: broadcast to every group (the
        reference stores schema per group for its tablets; replicating
        the full text everywhere is a superset with identical
        semantics)."""
        for gid in sorted(self.groups):
            self.groups[gid].alter(schema_text, **kw)

    # bounded re-route budget for requests racing a tablet move: a
    # typed TabletMisrouted (the owner flipped after our map fetch)
    # re-fetches the map and re-routes immediately; a write-fence
    # rejection ("is being moved") backs off and retries — the fence
    # is bounded by zero's --move-fence-timeout, so the whole budget
    # comfortably outlasts one fence window. Neither ever surfaces to
    # the user inside the budget.
    MISROUTE_RETRIES = 4
    FENCE_RETRY_S = 8.0

    def _retry_routed(self, fn):
        """Run `fn()` (which fetches a FRESH tablet map each attempt)
        under the misroute/fence retry contract above."""
        deadline = time.monotonic() + self.FENCE_RETRY_S
        misroutes = 0
        delay = 0.05
        while True:
            try:
                return fn()
            except TabletMisrouted:
                misroutes += 1
                if misroutes > self.MISROUTE_RETRIES:
                    raise
                continue  # next attempt re-fetches the map: re-route
            except RuntimeError as e:
                if "is being moved" not in str(e) \
                        or time.monotonic() >= deadline:
                    raise
                time.sleep(delay)  # fenced: short bounded backoff
                delay = min(0.4, delay * 2)

    def mutate(self, **kw) -> dict:
        def attempt():
            try:
                gid = self._group_for(self._preds_of_mutation(kw),
                                      claim=True, for_write=True)
            except SpanGroupsError:
                return self._mutate_multigroup(kw)
            return self.groups[gid].mutate(**kw)
        return self._retry_routed(attempt)

    def _mutate_multigroup(self, kw: dict) -> dict:
        """One mutation split across groups, committed atomically
        through Zero's oracle (2PC with Zero as transaction manager —
        ref worker/mutation.go:472 populateMutationMap fanning
        per-group fragments, zero/oracle.go:326 the single commit
        decision):

          1. blanks resolve to zero-leased uids BEFORE the split, so
             every group names the same entities
          2. each owning group replicates an xstage fragment at one
             global start_ts and reports its conflict keys
          3. zero's oracle decides (commit_ts or conflict abort) and
             RECORDS the decision — a participant that misses the
             finalize recovers it from zero (txn_status)
          4. xfinalize applies each fragment at commit_ts
        """
        from dgraph_tpu_torch.gql.nquad import (
            nquad_to_wire, parse_json_mutation, parse_rdf,
        )

        if kw.get("query") or kw.get("mutations") or kw.get("cond"):
            raise RuntimeError(
                "a cross-group upsert/conditional mutation is not "
                "supported; split it, or move the tablets together")
        # caller-pinned start_ts: the read-modify-write flow reads its
        # snapshot AT the txn's start_ts (pinned queries), so any
        # commit that lands between read and commit conflicts properly
        pinned_start = int(kw.get("start_ts", 0) or 0)
        nqs = []
        if kw.get("set_nquads"):
            nqs += [(n, False) for n in parse_rdf(kw["set_nquads"])]
        if kw.get("set_json") is not None:
            nqs += [(n, False)
                    for n in parse_json_mutation(kw["set_json"])]
        if kw.get("del_nquads"):
            nqs += [(n, True) for n in parse_rdf(kw["del_nquads"])]
        if kw.get("delete_json") is not None:
            nqs += [(n, True) for n in parse_json_mutation(
                kw["delete_json"], delete=True)]
        if any(nq.predicate == "*" for nq, _ in nqs):
            raise RuntimeError(
                "S * * wildcard deletes cannot span groups; delete "
                "per predicate or move the tablets together")

        # blanks -> one zero lease, substituted before the split
        blanks: dict[str, int] = {}
        for nq, _ in nqs:
            for ref in (nq.subject, nq.object_id):
                if ref and ref.startswith("_:"):
                    blanks.setdefault(ref, 0)
        if blanks:
            first = self.zero.assign_uids(len(blanks))
            for i, k in enumerate(sorted(blanks)):
                blanks[k] = first + i

        tmap = self.tablet_map()
        splits = tmap.get("splits", {})
        by_group: dict[int, list] = {}
        for nq, is_del in nqs:
            if nq.subject in blanks or nq.object_id in blanks:
                from dataclasses import replace as _rp
                nq = _rp(nq,
                         subject=hex(blanks[nq.subject])
                         if nq.subject in blanks else nq.subject,
                         object_id=hex(blanks[nq.object_id])
                         if nq.object_id in blanks else nq.object_id)
            if nq.predicate in splits:
                # hash-range split: route per resolved SUBJECT uid
                # (blanks were substituted above, so every row has
                # one) — the 2PC stage below makes the cross-shard
                # write atomic exactly like any cross-group write
                from dgraph_tpu_torch.cluster.shard import owner_for_uid
                try:
                    uid = int(nq.subject, 0)
                except ValueError:
                    raise RuntimeError(
                        f"cannot route a write to split tablet "
                        f"{nq.predicate!r}: subject {nq.subject!r} "
                        "is not a resolved uid") from None
                gid = owner_for_uid(splits[nq.predicate], uid)
            else:
                gid = tmap["tablets"].get(nq.predicate)
                if gid is None:
                    gid = self._group_for({nq.predicate}, claim=True,
                                          tmap=tmap)
                    tmap["tablets"][nq.predicate] = gid
            by_group.setdefault(gid, []).append(
                (nquad_to_wire(nq), is_del))

        start_ts = pinned_start or self.zero.assign_ts(1)
        keys: set[int] = set()
        staged: list[int] = []
        try:
            for gid in sorted(by_group):
                res = self.groups[gid]._unwrap(self.groups[gid].request(
                    {"op": "xstage", "start_ts": start_ts,
                     "nqs": by_group[gid]}))
                staged.append(gid)
                keys.update(res["keys"])
        except Exception:
            # stage failed somewhere: record the abort at zero FIRST
            # (so nothing can commit this ts later), then best-effort
            # clear the fragments that did stage
            try:
                self.zero.request({"op": "abort_txn",
                                   "args": (start_ts,)})
            except Exception:  # noqa: BLE001  # dglint: disable=DG07 (best-effort abort record inside a handler that re-raises)
                pass
            self._xabort(staged, start_ts)
            raise
        commit_ts = self.zero.commit(start_ts, sorted(keys))
        if not commit_ts:
            self._xabort(staged, start_ts)
            raise RuntimeError(
                f"transaction aborted: write-write conflict at "
                f"startTs {start_ts}")
        for gid in staged:
            try:
                self.groups[gid].request(
                    {"op": "xfinalize", "start_ts": start_ts,
                     "commit_ts": commit_ts})
            except Exception:  # noqa: BLE001 — the decision is  # dglint: disable=DG07 (finalize delivery is best-effort BY CONTRACT; reconcile covers it)
                pass  # recorded; the group reconciles from zero
        return {"uids": {k[2:]: hex(v) for k, v in blanks.items()},
                "extensions": {"txn": {"start_ts": start_ts,
                                       "commit_ts": commit_ts,
                                       "groups": staged}}}

    def _xabort(self, gids, start_ts: int):
        for gid in gids:
            try:
                self.groups[gid].request(
                    {"op": "xfinalize", "start_ts": start_ts,
                     "commit_ts": 0})
            except Exception:  # noqa: BLE001 — reconciliation covers it  # dglint: disable=DG07 (abort fan-out is best-effort BY CONTRACT)
                pass

    def query(self, q: str, variables: Optional[dict] = None,
              deadline_ms: Optional[int] = None,
              best_effort: bool = False, tenant: str = "") -> dict:
        """Route to the owning group; when a document's top-level
        blocks touch DIFFERENT groups, scatter block-wise and gather
        (the reference fans per-attr tasks to group leaders,
        worker/task.go:131; block-level is the coarser granularity the
        predicate-sharded store supports without cross-group joins —
        blocks connected by variables must stay within one group).
        `deadline_ms` bounds the whole routed query: the remaining
        budget rides every downstream RPC (groups/tasks inherit it).

        `best_effort` reads spread across the group's READ POOL
        (voters + learners) as watermark-bounded follower reads at a
        shared zero-granted read_ts; cross-group documents fall back
        to the leader-routed paths unchanged."""
        from dgraph_tpu_torch.gql import parse
        from dgraph_tpu_torch.server.acl import query_predicates

        ctx = None
        if deadline_ms is not None:
            from dgraph_tpu_torch.utils.reqctx import RequestContext
            ctx = RequestContext.from_deadline_ms(deadline_ms)
        parsed = parse(q, variables)
        preds = {p.lstrip("~") for p in query_predicates(parsed)}

        def attempt():
            tmap = self.tablet_map()
            try:
                gid = self._group_for(preds, claim=False, tmap=tmap)
            except SpanGroupsError:
                # one map drives both the span decision and the
                # per-block assignment — no second fetch, no TOCTOU
                # between them
                try:
                    return self._scatter_query(q, variables, parsed,
                                               tmap, ctx)
                except _NeedsFederation:
                    # a single block spans groups / a var crosses
                    # groups / a split sub-tablet fan-out: run the
                    # full executor here with per-attr task RPCs to
                    # each owning group (ref worker/task.go:131)
                    return self._federated_query(q, variables,
                                                 tmap, ctx)
            if best_effort:
                return self._be_query(gid, q, variables, ctx, tenant)
            return self.groups[gid].query(
                q, variables,
                deadline_ms=ctx.remaining_ms() if ctx else None)
        # a move's flip between our map fetch and the read lands a
        # TYPED TabletMisrouted (never silent empties): re-fetch the
        # map and re-route, bounded — queries never fence, so "is
        # being moved" cannot surface here
        return self._retry_routed(attempt)

    # ------------------------------------------------- follower reads

    # membership refresh cadence for the per-group read pools: a new
    # learner starts taking reads within this bound; a dead one costs
    # at most one failed dial per pass until the next refresh
    READ_POOL_REFRESH_S = 2.0
    # best-effort reads within one window share a single zero-granted
    # read_ts (the "read_ts-class"): zero grants one ts per window
    # instead of one per read — the grant RPC drops off the read hot
    # path — and every replica's result cache keys the window's reads
    # identically, so concurrent hot queries hit across requests
    READ_TS_WINDOW_S = 0.05

    def _granted_read_ts(self) -> int:
        """The current read window's timestamp (cached ~50 ms)."""
        now = time.monotonic()
        with self._read_lock:
            ts, at = self._read_ts_grant
            if ts and now - at < self.READ_TS_WINDOW_S:
                return ts
        # non-bumping grant: zero's CURRENT max ts. A fresh assign_ts
        # would stall idle clusters — no commit ever lands on a
        # read-only allocation, so no replica's applied watermark
        # could ever cover it
        fresh = self.zero.read_ts()
        with self._read_lock:
            # two racers both fetch: keep the NEWER grant (read_ts
            # never goes backwards within a client)
            if fresh > self._read_ts_grant[0]:
                self._read_ts_grant = (fresh, now)
            return self._read_ts_grant[0]

    def _read_pool(self, gid: int) -> tuple[ClusterClient, list[int]]:
        """The read-serving client for `gid`: every replica (voters +
        learners) from zero's membership, falling back to the write
        client's voter addrs when zero has no record (e.g. a
        statically-configured group that never registered)."""
        now = time.monotonic()
        with self._read_lock:
            st = self._read_pools.get(gid)
            if st is not None \
                    and now - st["at"] < self.READ_POOL_REFRESH_S:
                return st["client"], st["order"]
        addrs: dict[int, tuple] = {}
        resp = self.zero.request({"op": "cluster_state"})
        if resp.get("ok"):
            for rec in resp["result"].get("alphas", {}).values():
                if int(rec.get("group", 0)) == int(gid):
                    addrs[int(rec["id"])] = tuple(rec["client"])
        if not addrs:
            addrs = {n: tuple(a)
                     for n, a in self.groups[gid].addrs.items()}
        old = None
        with self._read_lock:
            st = self._read_pools.get(gid)
            if st is not None and st["addrs"] == addrs:
                st["at"] = now  # membership unchanged: keep the conns
                return st["client"], st["order"]
            client = ClusterClient(addrs)
            if st is not None:
                old = st["client"]
            self._read_pools[gid] = {
                "addrs": addrs, "client": client,
                "order": sorted(addrs), "at": now}
        if old is not None:
            old.close()
        return client, sorted(addrs)

    def _be_query(self, gid: int, q: str, variables,
                  ctx, tenant: str) -> dict:
        """Watermark-bounded follower read: one shared read_ts, tried
        round-robin across the group's replicas; StaleRead (replica's
        applied watermark behind the grant) or an unreachable replica
        rotates to the next one, and when EVERY replica fails the read
        falls back to the leader-routed pinned read at the same
        read_ts — which always qualifies (barrier + reconcile), so a
        best-effort read degrades in latency, never in consistency."""
        read_ts = self._granted_read_ts()
        client, order = self._read_pool(gid)
        with self._read_lock:
            start = self._rr
            self._rr += 1
        for i in range(len(order)):
            node = order[(start + i) % len(order)]
            if ctx is not None:
                ctx.check(f"follower read at node {node}")
            try:
                return client.query_at(
                    node, q, variables, read_ts=read_ts,
                    deadline_ms=ctx.remaining_ms() if ctx else None,
                    tenant=tenant)
            except (StaleRead, ConnectionError):
                continue
        return self.groups[gid].query(
            q, variables, read_ts=read_ts,
            deadline_ms=ctx.remaining_ms() if ctx else None)

    def _federated_query(self, q: str, variables: Optional[dict],
                         full_tmap: dict, ctx=None) -> dict:
        from dgraph_tpu_torch.cluster.federated import FederatedDB

        tmap = full_tmap["tablets"]
        splits = full_tmap.get("splits", {})
        read_ts = self.zero.assign_ts(1)
        fdb = FederatedDB(self.groups, tmap, "", read_ts, ctx=ctx,
                          splits=splits, device=self.device)
        # schema from every group: on-the-fly predicates exist only on
        # their owning group, so no single group has the whole picture
        for gid in sorted(self.groups):
            try:
                text = fdb._task(gid, {"op": "task",
                                       "kind": "schema_state",
                                       "read_ts": read_ts})
                if text:
                    fdb.schema.apply_text(text)
            except RuntimeError:
                continue  # group down: its tablets will error if used
        out = fdb.query(q, variables)
        out.setdefault("extensions", {})["federated"] = True
        out["extensions"]["read_ts"] = read_ts
        touched = {p: {"owners": [int(g) for g in
                                  splits[p]["owners"]]}
                   for p in splits
                   if p in fdb.tablets.keys()}  # instantiated only
        if touched:
            # EXPLAIN-adjacent visibility: which sub-tablet fan-outs
            # served this query (mirrors zero /state `splits`)
            out["extensions"]["splitRouting"] = touched
        return out

    def _scatter_query(self, q: str, variables: Optional[dict],
                       parsed, full_tmap: dict, ctx=None) -> dict:
        from dgraph_tpu_torch.server.acl import block_predicates

        tmap = full_tmap["tablets"]
        splits = full_tmap.get("splits", {})
        # assign each top-level block to its owning group; blocks
        # sharing variables must land on ONE group (a var defined in
        # group A cannot feed a block served by group B)
        var_home: dict[str, int] = {}
        assign: list[tuple[int, Any]] = []
        for gq in parsed.queries:
            bpreds = {p.lstrip("~") for p in block_predicates(gq)}
            if any(p in splits for p in bpreds):
                # a split predicate's rows span groups within ONE
                # block: only the federated fan-out can union them
                raise _NeedsFederation(gq.alias)
            owners = {tmap[p] for p in bpreds if p in tmap}
            if len(owners) > 1:
                raise _NeedsFederation(gq.alias)
            gid = owners.pop() if owners else min(self.groups)
            for vc in self._block_var_uses(gq):
                home = var_home.get(vc)
                if home is not None and home != gid:
                    raise _NeedsFederation(vc)
                var_home[vc] = gid
            assign.append((gid, gq))

        # one zero-issued GLOBAL timestamp pins every group's MVCC
        # snapshot: the scatter reads a single consistent cut of the
        # cluster (groups share zero's ts order, so "commits <= T"
        # means the same instant everywhere)
        read_ts = self.zero.assign_ts(1)
        # the full document runs on every involved group (var chains
        # assigned to that group resolve completely there); each
        # block's RESULT is taken from its owning group only
        merged: dict = {"data": {},
                        "extensions": {"scatter": [],
                                       "read_ts": read_ts}}
        for gid in sorted({g for g, _ in assign}):
            if ctx is not None:
                ctx.check(f"scatter to group {gid}")
            out = self.groups[gid].query(
                q, variables, read_ts=read_ts,
                deadline_ms=ctx.remaining_ms() if ctx else None)
            data = out.get("data", {})
            # response shape must not depend on tablet placement:
            # carry extensions like the single-group path does
            for k, v in out.get("extensions", {}).items():
                merged["extensions"].setdefault(k, v)
            merged["extensions"]["scatter"].append(gid)
            for g, gq in assign:
                if g != gid or gq.alias == "var":
                    continue
                key = gq.alias
                if key in data:
                    merged["data"][key] = data[key]
                if gq.attr == "shortest" and "_path_" in data:
                    merged["data"]["_path_"] = data["_path_"]
        return merged

    @staticmethod
    def _block_var_uses(gq) -> set[str]:
        """Every variable a block defines or consumes — including
        filter trees, shortest from/to, expand(var), math trees and
        facet vars; missing any of these would let a cross-group var
        slip past the guard and silently resolve empty."""
        names = set()

        def walk_filter(ft):
            if ft is None:
                return
            if ft.func is not None:
                for vc in ft.func.needs_var:
                    names.add(vc.name)
            for c in ft.children:
                walk_filter(c)

        def walk_math(mt):
            if mt is None:
                return
            if mt.var:
                names.add(mt.var)
            for c in mt.children:
                walk_math(c)

        def walk(g):
            if g.var:
                names.add(g.var)
            for vc in g.needs_var:
                names.add(vc.name)
            if g.func:
                for vc in g.func.needs_var:
                    names.add(vc.name)
            walk_filter(g.filter)
            if g.shortest is not None:
                for fn in (g.shortest.from_, g.shortest.to):
                    if fn is not None:
                        for vc in fn.needs_var:
                            names.add(vc.name)
            if getattr(g, "expand", ""):
                names.add(g.expand)  # may be a var (or _all_/a type)
            walk_math(getattr(g, "math", None))
            for v in getattr(g, "facet_var", {}).values():
                names.add(v)
            for c in g.children:
                walk(c)

        walk(gq)
        return names

    # --------------------------------------------------------- tablet move

    def move_tablet(self, pred: str, dst_group: int,
                    timeout_s: float = 60.0) -> None:
        """Live predicate move, OWNED by the Zero quorum (ref
        zero/tablet.go:62 movetablet + worker/predicate_move.go): this
        client only files the request and waits on the replicated move
        LEDGER. Zero's leader drives snapshot stream -> CDC catch-up
        -> bounded-lag fence -> ownership flip -> source drop,
        persisting each phase through its Raft group, so the move
        completes (or aborts cleanly, pre-flip) even if THIS process —
        or the Zero leader itself — dies mid-move. The source serves
        reads AND writes throughout; only the short `fenced` phase
        rejects writes to this one predicate. Concurrent movers
        serialize at the ledger: the second request returns 'already
        moving'."""
        tmap = self.tablet_map()
        src = tmap["tablets"].get(pred)
        if src is None:
            raise RuntimeError(f"tablet {pred!r} is not served anywhere")
        if src == dst_group:
            return
        resp = self.zero.request({"op": "move_request",
                                  "args": (pred, dst_group)})
        if not resp.get("ok") or not resp.get("result"):
            raise RuntimeError(
                f"tablet {pred!r} move refused: "
                f"{resp.get('error', 'already moving?')}")
        self._await_move(pred, dst_group, timeout_s)

    def split_tablet(self, pred: str, dst_group: int,
                     nshards: int = 2, shard: Optional[int] = None,
                     timeout_s: float = 60.0) -> None:
        """Split a hot predicate into `nshards` hash-range sub-tablets
        by moving `shard` (default: the last one) onto `dst_group` —
        same crash-safe phase machine as move_tablet; after the flip
        the routing map carries a `splits` entry and reads fan out
        (cluster/federated.py), writes route per subject uid."""
        shard = nshards - 1 if shard is None else int(shard)
        resp = self.zero.request(
            {"op": "move_request",
             "args": (pred, dst_group, int(nshards), shard)})
        if not resp.get("ok") or not resp.get("result"):
            raise RuntimeError(
                f"tablet {pred!r} split refused: "
                f"{resp.get('error', 'already moving/split?')}")
        self._await_move(pred, dst_group, timeout_s, split=True)

    def _await_move(self, pred: str, dst_group: int, timeout_s: float,
                    split: bool = False) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                tmap = self.tablet_map()
            except RuntimeError:
                time.sleep(0.3)  # zero election in progress
                continue
            if pred not in tmap.get("moves", {}):
                if split:
                    ent = tmap.get("splits", {}).get(pred)
                    if ent and int(dst_group) in \
                            {int(g) for g in ent["owners"]}:
                        return
                elif tmap["tablets"].get(pred) == dst_group:
                    return
                raise RuntimeError(
                    f"tablet {pred!r} move aborted by zero "
                    f"(owner is group {tmap['tablets'].get(pred)})")
            time.sleep(0.2)
        raise TimeoutError(
            f"tablet {pred!r} move still in flight after {timeout_s}s "
            "(zero keeps driving it; check tablet_map later)")

    def abort_move(self, pred: str, dst_group: int) -> bool:
        """Abort an in-flight move without flipping ownership — the
        operator escape hatch. Refused (False) once the move has
        flipped: the destination then owns the only routed copy. On a
        successful pre-flip abort the destination's staged/installed
        copy is dropped too — the streaming path installs the copy
        long before the flip, and leaving it would strand a stale
        orphan whose size/heat reports skew the rebalancer."""
        resp = self.zero.request({"op": "tablet_move_abort",
                                  "args": (pred, dst_group)})
        ok = bool(resp.get("ok") and resp.get("result"))
        if ok and dst_group in self.groups:
            try:
                self.groups[dst_group].request(
                    {"op": "drop_tablet", "pred": pred})
            except Exception:  # noqa: BLE001 — best-effort cleanup  # dglint: disable=DG07 (abort cleanup is best-effort BY CONTRACT)
                pass
        return ok

    def close(self):
        self.zero.close()
        for c in self.groups.values():
            c.close()
        with self._read_lock:
            pools = [st["client"] for st in self._read_pools.values()]
            self._read_pools.clear()
        for c in pools:
            c.close()


class Rebalancer:
    """Periodic tablet rebalancing (ref zero/tablet.go:62
    rebalanceTablets, default every 8 minutes): each tick compares
    group loads and live-moves ONE tablet from the heaviest group to
    the least loaded, converging the cluster a step at a time exactly
    like the reference (chooseTablet moves one predicate per cycle so
    a bad heuristic can never thrash the whole keyspace at once).

    Load = tablet count by default; pass size_fn(pred) for a
    byte-weighted choice (the reference weighs by tablet space from
    membership reports)."""

    def __init__(self, cluster: RoutedCluster,
                 interval_s: float = 480.0, threshold: int = 2,
                 size_fn=None, use_reported: bool = None):
        import threading
        self.cluster = cluster
        self.interval_s = interval_s
        self.threshold = threshold
        self.size_fn = size_fn or (lambda pred: 1)
        # honor the alphas' byte reports only when the caller's
        # threshold is byte-scale (mixing byte weights with a
        # tablet-count threshold would move on a 2-byte spread)
        self.use_reported = (threshold > 4096) \
            if use_reported is None else use_reported
        self.moves: list[tuple[str, int, int]] = []
        self._stop = threading.Event()
        self._thread: Optional[Any] = None

    def tick(self) -> Optional[tuple[str, int, int]]:
        """One rebalance pass; returns the move made, if any."""
        tmap = self.cluster.tablet_map()
        by_group: dict[int, list[str]] = {
            g: [] for g in self.cluster.groups}
        for pred, gid in tmap["tablets"].items():
            if pred in tmap["moving"] or pred.startswith("dgraph."):
                continue
            by_group.setdefault(gid, []).append(pred)
        # byte weights from the alphas' periodic size reports when
        # zero has them (ref zero/tablet.go:180); explicit size_fn or
        # count otherwise
        reported = tmap.get("sizes", {}) if self.use_reported else {}

        def weigh(pred: str) -> int:
            got = reported.get(pred)
            # 0 is a legitimate report (emptied tablet), not "missing"
            return int(got) if got is not None else self.size_fn(pred)

        load = {g: sum(weigh(p) for p in ps)
                for g, ps in by_group.items()}
        heavy = max(sorted(load), key=lambda g: load[g])
        light = min(sorted(load), key=lambda g: load[g])
        if load[heavy] - load[light] < self.threshold \
                or not by_group[heavy]:
            return None
        # smallest tablet that still helps — the move must STRICTLY
        # shrink the pair's spread, else a big tablet just mirrors the
        # imbalance and the next tick moves it straight back, an
        # export/import oscillation forever (ref chooseTablet walks
        # candidates until the move improves the spread)
        spread = load[heavy] - load[light]
        for pred in sorted(by_group[heavy],
                           key=lambda p: (weigh(p), p)):
            sz = weigh(pred)
            if abs((load[heavy] - sz) - (load[light] + sz)) < spread:
                self.cluster.move_tablet(pred, light)
                move = (pred, heavy, light)
                self.moves.append(move)
                return move
        return None

    def start(self):
        import threading

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — keep rebalancing  # dglint: disable=DG07 (rebalancer daemon; no request context flows here)
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
