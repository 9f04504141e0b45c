"""GraphDB: the single-process engine (Alpha-equivalent).

API surface mirrors the reference's api.Dgraph service as implemented by
edgraph/server.go: Alter (server.go:76), Query/Mutate via doQuery
(server.go:634-731, :220 doMutate), CommitOrAbort (server.go:920) — as
Python methods instead of gRPC handlers (the serving layer wraps this).

Mutation semantics ported from behavior (not structure):
  - blank nodes get fresh leased uids (query/mutation.go:114 AssignUids)
  - edges route to per-predicate tablets (worker/mutation.go:472
    populateMutationMap)
  - conflict keys fingerprint (pred, src uid) — or (pred, index token)
    for @upsert predicates (posting/index.go:305 addMutationHelper)
  - commit assigns commit_ts at the coordinator, then the apply loop
    stamps tablet deltas (worker/draft.go:435 processApplyCh ordering)
  - an overwrite of a single-valued indexed predicate emits index deletes
    for the old value's tokens (posting/index.go:83 addIndexMutations)

Port of `dgraph_tpu/engine/db.py`. Schema (`alter`), transactions and
`mutate` (RDF, JSON, `mutations=`, upsert blocks and @if conditions),
commit, discard, `apply_record` and WAL replay, `rollup_all` (which
trains the vector indexes on the engine's device), `query` and
`query_json` (through the plan cache and the adaptive planner by
default), `bfs`, the tablet exports (sharded ones included), `state`
and `debug_stats` behave as the reference's. The engine runs on
`device` (None: the card); its tablets, tiles and vector indexes live
there, and every device tier of the query path runs there.

`mesh` (a `parallel.mesh.Mesh`) takes predicates of at least
`shard_min_edges` edges onto the mesh's `uid` shards
(`device_cache.device_sharded_adjacency`), and similar_to onto its
sharded tiers.

`store_dir` keeps the tablets in a store on disk (engine/lazy_tablets)
and materializes each on the engine's device when a request reaches it,
under `tablet_budget` host bytes; `checkpoint` and `close` persist it.
`result_cache_entries` caches whole responses (engine/result_cache),
and `prefetch_workers` decodes stored tablets ahead of the blocks that
read them (engine/prefetch), as the reference's.
"""

from __future__ import annotations

import hashlib
import json as _json
import time
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Any, Optional

import numpy as np
import torch

from dgraph_tpu_torch.backend import resolve_device
from dgraph_tpu_torch.cluster.coordinator import (  # noqa: F401 (API)
    Coordinator, StaleSnapshot, TxnAborted,
)
from dgraph_tpu_torch.gql import parse as gql_parse
from dgraph_tpu_torch.gql.nquad import NQuad, parse_json_mutation, parse_rdf
from dgraph_tpu_torch.models.schema import PredicateSchema, SchemaState
from dgraph_tpu_torch.models.types import TypeID, Val, convert
from dgraph_tpu_torch.storage.tablet import EdgeOp, Posting, Tablet
from dgraph_tpu_torch.storage.wal import Wal
from dgraph_tpu_torch.utils import coststore, metrics, reqlog
from dgraph_tpu_torch.utils.tracing import bind_request, span as _span

# measured device dispatch RTT per device (device_dispatch_seconds)
_DISPATCH_SECONDS: dict[str, float] = {}


def _skel_of(plan) -> str:
    """A plan's 16-hex skeleton hash ("" on the interpreted path) —
    the shared join key across the coststore, the request log and
    EXPLAIN output."""
    return plan.skeleton_hex if plan is not None else ""


def _fp(*parts) -> int:
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        if isinstance(p, bytes):
            h.update(p)
        else:
            h.update(str(p).encode())
        h.update(b"\x1f")
    return int.from_bytes(h.digest(), "big")


@dataclass
class Txn:
    """Client-side transaction handle. Ref: dgo txn / pb.TxnContext."""

    start_ts: int
    _state: Any = None
    staged: list[tuple[str, EdgeOp]] = field(default_factory=list)
    conflict_keys: set = field(default_factory=set)
    uid_map: dict[str, int] = field(default_factory=dict)  # blank -> uid
    done: bool = False


@dataclass
class Mutation:
    """One mutation of a (possibly conditional upsert) request.
    Ref api.Mutation: SetNquads/DelNquads/SetJson/DeleteJson/Cond."""

    set_nquads: str = ""
    del_nquads: str = ""
    set_json: Any = None
    delete_json: Any = None
    cond: str = ""


@dataclass
class Latency:
    """Per-phase latency returned with every response
    (ref api.Latency, edgraph/server.go:717)."""

    parsing_ns: int = 0
    processing_ns: int = 0
    encoding_ns: int = 0
    assign_ts_ns: int = 0

    def as_dict(self):
        return {"parsing_ns": self.parsing_ns,
                "processing_ns": self.processing_ns,
                "encoding_ns": self.encoding_ns,
                "assign_timestamp_ns": self.assign_ts_ns}

    def total_ns(self) -> int:
        return (self.parsing_ns + self.processing_ns
                + self.encoding_ns + self.assign_ts_ns)

    def server_latency(self):
        """Dgraph v1.1 `extensions.server_latency` response schema
        (ref protos/api Latency as serialized by edgraph/server.go:717:
        parsing/processing/encoding plus the total)."""
        return {"parsing_ns": self.parsing_ns,
                "processing_ns": self.processing_ns,
                "encoding_ns": self.encoding_ns,
                "total_ns": self.total_ns()}


class GraphDB:
    # dglint: guarded-by=*:external (the engine data plane carries no
    # internal locks by design: mutations run on the single raft-apply
    # thread or under AlphaServer._write_lock, queries under the
    # server's rw read lock — the synchronization contract lives in
    # cluster/service.py; utils/racecheck.py witnesses violations of
    # it at runtime)
    def __init__(self, wal_path: str | None = None,
                 prefer_device: bool = True,
                 device_min_edges: int = 1024,
                 device_hbm_budget: int = 2 << 30,
                 mesh=None, shard_min_edges: int = 1 << 18,
                 enc_key: bytes | None = None,
                 store_dir: str | None = None,
                 tablet_budget: int = 256 << 20,
                 rollup_window: int = 0,
                 prefer_columnar: bool = True,
                 prefer_compressed: bool = True,
                 host_tile_budget: int = 512 << 20,
                 plan_cache_size: int = 128,
                 planner: str = "auto",
                 vec_quantized: bool = True,
                 vec_index_min_rows: int = 1 << 17,
                 vec_target_recall: float = 0.98,
                 vec_nprobe: int | None = None,
                 vec_rerank: int | None = None,
                 vec_max_k: int = 128,
                 result_cache_entries: int = 0,
                 prefer_fused: bool = True,
                 fused_min_rows: int = 1024,
                 prefetch_workers: int = 0,
                 planner_explore: bool = True,
                 device=None):
        from dgraph_tpu_torch.engine.tile_cache import DeviceCacheLRU
        from dgraph_tpu_torch.ops.codec import DecodeScratch
        from dgraph_tpu_torch.query.plan import PlanCache

        # where tablets build their tiles and vector indexes
        self.device = resolve_device(device)
        self.schema = SchemaState()
        # compiled plan cache (query/plan.py): parse + skeleton-keyed
        # executables. schema_epoch is a plan-cache key component —
        # every schema change bumps it, making stale plans unreachable.
        # 0 disables (every request takes the interpreted path).
        self.schema_epoch = 0
        self.plan_cache = PlanCache(plan_cache_size) \
            if plan_cache_size else None
        self.coordinator = Coordinator()
        self.tablet_store = None
        if store_dir is not None:
            # disk-backed mode: tablet base state lives in the native
            # LSM store and materializes per predicate on demand, on
            # this engine's device, evicting LRU under tablet_budget
            # (the Badger role, posting/mvcc.go:143 — datasets larger
            # than RAM load and serve). See engine/lazy_tablets.py.
            from dgraph_tpu_torch.engine.lazy_tablets import (
                TabletMap, TabletStore,
            )
            self.tablet_store = TabletStore(store_dir, self.device)
            text = self.tablet_store.load_schema()
            if text:
                self.schema.apply_text(text)
            self.tablets: dict[str, Tablet] = TabletMap(
                self, self.tablet_store, tablet_budget)
            for pred in self.tablets.stored:
                self.coordinator.should_serve(pred)
            # resume timestamps past the persisted base state (reads
            # below a reloaded tablet's base_ts are stale snapshots)
            self.coordinator.observe_ts(self.tablet_store.load_max_ts())
        else:
            self.tablets = {}
        self.prefer_device = prefer_device
        self.device_min_edges = device_min_edges
        # columnar scan tier switch: False pins every read to the
        # exact per-posting path (the differential parity suite's
        # oracle; also an operator escape hatch)
        self.prefer_columnar = prefer_columnar
        # compressed posting tier: token-index set algebra runs on
        # ops/codec CompressedPack blocks (resident footprint =
        # compressed bytes, decode only surviving blocks). Requires
        # the columnar tier; False keeps the dense CSR exports.
        self.prefer_compressed = prefer_compressed
        # cost-based adaptive planner (query/planner.py): per-stage
        # tier choice from tabstats row estimates x coststore observed
        # cost, decisions cached on the compiled plan, invalidated on
        # estimate violation / cost drift. "static" pins the static
        # flag heuristics (the parity oracle for planner testing). The
        # prefer_* flags above DEMOTE to overrides: they bound which
        # tiers the planner may pick, they no longer decide per stage.
        # Adaptive needs the plan cache (decisions live on plans):
        # "auto" (the default) resolves to adaptive when the cache is
        # on and static otherwise; an EXPLICIT "adaptive" on a
        # cache-less engine raises rather than silently demoting.
        if planner not in ("auto", "adaptive", "static"):
            raise ValueError(
                f"planner must be 'auto', 'adaptive' or 'static', "
                f"got {planner!r}")
        if planner == "adaptive" and self.plan_cache is None:
            raise ValueError(
                "planner='adaptive' needs the plan cache "
                "(plan_cache_size > 0): decisions are cached on "
                "compiled plans")
        if planner in ("auto", "adaptive") \
                and self.plan_cache is not None:
            from dgraph_tpu_torch.query.planner import AdaptivePlanner
            self.planner = "adaptive"
            self.planner_impl: Any = AdaptivePlanner(self)
        else:
            self.planner = "static"
            self.planner_impl = None
        # budgeted cold-tier exploration (query/planner.py
        # _maybe_explore): False pins decisions to evidence + the
        # static ladder only — deterministic tier choice for parity
        # suites and per-shape benchmark tables
        self.planner_explore = planner_explore
        # whole-plan device fusion (query/fusion.py): an eligible
        # block's filter+order+page chain runs as ONE executable per
        # (skeleton, shape-bucket, mesh). False pins
        # every block to the staged per-stage pipeline — the fusion
        # parity suite's oracle and the operator escape hatch;
        # fused_min_rows keeps tiny roots (where one dispatch costs
        # more than the host pipeline) staged
        self.prefer_fused = prefer_fused
        self.fused_min_rows = fused_min_rows
        # async cold-store prefetch (engine/prefetch.py): a bounded
        # worker pool decodes stored tablet blobs announced by the
        # executor before block execution reaches them. 0 (the
        # default) disables — every store load stays synchronous and
        # the query path takes zero new branches. Opt-in because it
        # only pays on store-backed engines whose working set exceeds
        # tablet_budget
        self.prefetcher = None
        if prefetch_workers and self.tablet_store is not None:
            from dgraph_tpu_torch.engine.prefetch import PrefetchPool
            self.prefetcher = PrefetchPool(self.tablet_store,
                                           workers=prefetch_workers)
        # bounded per-thread scratch arena the compressed kernels
        # decode into (results are always fresh; see DecodeScratch)
        self.decode_scratch = DecodeScratch()
        # uid-range sharding across a device mesh (`uid` axis):
        # predicates above shard_min_edges expand across the mesh's uid
        # shards instead of a single device (ref posting/list.go:1149
        # multi-part posting lists; SURVEY §5.7)
        self.mesh = mesh
        self.shard_min_edges = shard_min_edges
        # quantized ANN tier for similar_to (ops/ivf.py via
        # storage/vecstore.py): IVF k-means + int8 residual codes,
        # trained at rollup on clean base blocks once a vector
        # predicate crosses vec_index_min_rows (below it the exact
        # tiers are already fast), recall budgeted by
        # vec_target_recall at build. vec_quantized=False removes the
        # tier everywhere (the exact-path parity oracle, same policy
        # as prefer_columnar); vec_nprobe / vec_rerank override the
        # calibrated probe count and re-rank depth; k > vec_max_k
        # falls back to the exact tiers (calibration holds at
        # k_ref=10, not at arbitrary depth)
        self.vec_quantized = vec_quantized
        self.vec_index_min_rows = vec_index_min_rows
        self.vec_target_recall = vec_target_recall
        self.vec_nprobe = vec_nprobe
        self.vec_rerank = vec_rerank
        self.vec_max_k = vec_max_k
        # background rollups lag this many LOGICAL ts behind the
        # newest commit, so pinned snapshot readers (zero-issued
        # global ts) rarely find their snapshot already folded; a
        # reader that still does gets a retryable StaleSnapshot, never
        # silently-newer data. 0 (the embedded default) folds
        # everything foldable; the cluster AlphaServer raises it —
        # only there do remotely issued read timestamps roam
        self.rollup_window = rollup_window
        # HBM residency budget for device tiles (ref posting/lists.go
        # LRU bound on cached posting lists) + host budget for the
        # columnar/compressed exports riding the same LRU
        self.device_cache = DeviceCacheLRU(device_hbm_budget,
                                           host_tile_budget)
        self.enc_key = enc_key
        # cross-group 2PC participants: start_ts -> (staged ops, keys).
        # Replicated via ("xstage", ...) records so the stage survives
        # leader changes; resolved by ("xfinalize", start_ts, commit_ts)
        # once Zero's oracle decides (ref worker/mutation.go:432
        # proposeOrSend + zero/oracle.go commit decisions)
        self.pending_txns: dict[int, tuple[list, list]] = {}
        # tablets this engine SERVED and then moved away (the
        # ("move_drop", pred, dst) record): pred -> destination group.
        # The serving layer answers requests that still name one of
        # these with a TYPED misroute (cluster/errors.TabletMisrouted)
        # so a client holding a pre-flip routing map re-fetches and
        # re-routes instead of reading silently-empty state. Bounded;
        # replicated (the record applies on every group member).
        self.moved_out: dict[str, int] = {}
        # predicates this engine serves only a HASH RANGE of (the
        # source after split_prune, the destination after a shard
        # import): a single-group query naming one must fail typed —
        # serving it locally would silently return partial rows to a
        # client whose routing map predates the split flip. Replicated
        # (both records apply on every member) and snapshot-carried.
        self.split_partial: set[str] = set()
        # change streams (cdc/): bounded per-predicate change logs
        # tailing the committed apply path — the same expanded records
        # the WAL frames and Raft replicates, so a WAL replay below
        # rebuilds the tail and every replica derives identical
        # offsets. Served by /subscribe (server/http.py) and the
        # {"op": "subscribe"} wire op (cluster/service.py).
        from dgraph_tpu_torch.cdc.changelog import CdcPlane
        self.cdc = CdcPlane()
        # CDC-invalidated result cache (engine/result_cache.py): full
        # serialized responses keyed on the plan skeleton, invalidated
        # per predicate by the local change log's observer. 0 (the
        # default) disables: the query path takes zero new branches.
        self.result_cache = None
        if result_cache_entries:
            from dgraph_tpu_torch.engine.result_cache import ResultCache
            self.result_cache = ResultCache(result_cache_entries)
            self.cdc.on_invalidate = self.result_cache.invalidate
        self.wal = Wal(wal_path, key=enc_key) if wal_path else None
        # optional record sink: Raft replication taps the same durable
        # record stream the WAL gets (cluster/replica.py)
        self.on_record = None
        # observed-cost persistence: a store-backed engine reloads the
        # coststore's stage-duration table at boot (merge, never
        # truncate) and saves at checkpoint/close, so the planner's
        # observations survive restarts. The table is process-global
        # (spans carry no engine identity): at most one store-backed
        # engine per process, or their files cross-pollinate
        self._coststore_path = None
        if store_dir is not None:
            import os as _os
            self._coststore_path = _os.path.join(store_dir,
                                                 "coststore.json")
            coststore.load(self._coststore_path)
        if self.wal:
            self._replay()

    # ------------------------------------------------------------------
    # Alter (ref edgraph/server.go:76)
    # ------------------------------------------------------------------

    def alter(self, schema_text: str = "", drop_all: bool = False,
              drop_attr: str = "", ctx=None):
        if ctx is not None:
            ctx.check("alter")
        self._bump_schema_epoch()
        if drop_all:
            for tab in self.tablets.values():
                self.device_cache.drop_tablet(tab)
            self.tablets.clear()
            self.schema = SchemaState()
            self.cdc.clear()
            if self.wal:
                self.wal.truncate()
            self._log_record(("drop_all",))
            return
        if drop_attr:
            dropped = self.tablets.pop(drop_attr, None)
            if dropped is not None:
                self.device_cache.drop_tablet(dropped)
            self.schema.delete_predicate(drop_attr)
            self.cdc.drop(drop_attr)
            self._log_record(("drop_attr", drop_attr))
            return
        preds, types = self.schema.apply_text(schema_text)
        for ps in preds:
            t = self.tablets.get(ps.predicate)
            if t is not None:
                old = t.schema
                t.schema = ps
                # index/reverse definition changed -> rebuild
                # (ref posting/index.go:601 IndexRebuild.Run)
                t.rollup(self.fold_watermark())
                if (old.indexed, tuple(old.tokenizers)) != \
                        (ps.indexed, tuple(ps.tokenizers)):
                    t.rebuild_index()
                if old.reverse != ps.reverse:
                    t.rebuild_reverse()
        self._log_record(("alter", schema_text))

    def _bump_schema_epoch(self):
        """Invalidate compiled plans: tokenizer/index/type decisions
        baked into a plan's stage constants are schema-derived, so any
        schema change must fence them. Predicates created on the fly
        by mutations do NOT bump — a new tablet only ADDS state a
        cached plan re-reads per request (tablets are looked up at
        execution, never baked in)."""
        self.schema_epoch += 1

    # ------------------------------------------------------------------
    # Transactions
    # ------------------------------------------------------------------

    def new_txn(self) -> Txn:
        st = self.coordinator.begin()
        return Txn(start_ts=st.start_ts, _state=st)

    def new_txn_at(self, start_ts: int) -> Txn:
        """Attach a txn to a read timestamp a query already handed out
        (stateless HTTP flow; ref posting.Oracle RegisterStartTs)."""
        st = self.coordinator.begin_at(start_ts)
        return Txn(start_ts=st.start_ts, _state=st)

    def mutate(self, txn: Optional[Txn] = None, *,
               ctx=None, **kw) -> dict:
        """See _mutate_inner; this wrapper binds the request trace,
        records the `mutate` span, and returns the Dgraph-compatible
        `extensions.server_latency` on every mutation response (for a
        staged-only mutation the whole stage counts as processing)."""
        t_start = time.perf_counter_ns()
        with bind_request(ctx), _span("mutate"):
            out = self._mutate_inner(txn, ctx=ctx, **kw)
        total = time.perf_counter_ns() - t_start
        sl = {"parsing_ns": 0, "processing_ns": total,
              "encoding_ns": 0, "total_ns": total}
        out.setdefault("extensions", {})["server_latency"] = sl
        reqlog.record("mutate",
                      trace_id=ctx.trace_id if ctx is not None else "",
                      latency_ms=total / 1e6, breakdown=sl,
                      tenant=getattr(ctx, "tenant", ""))
        return out

    def _mutate_inner(self, txn: Optional[Txn] = None, *,
                      set_nquads: str = "", del_nquads: str = "",
                      set_json: Any = None, delete_json: Any = None,
                      query: str = "", variables: dict | None = None,
                      mutations: Optional[list[Mutation]] = None,
                      cond: str = "",
                      commit_now: bool = False, ctx=None) -> dict:
        """Stage (and optionally commit) a mutation — optionally an upsert
        block: `query` runs first at the txn's startTs and its uid/value
        variables substitute into uid(v)/val(v) references in the
        mutations; each mutation's @if `cond` gates it on len(v) checks
        (ref edgraph/server.go:220 doMutate, :327 buildUpsertQuery,
        :503-511 updateUIDInMutations/updateValInMutations).

        Returns {"uids": {...}, "queries": {...}} like api.Response."""
        legacy = set_nquads or del_nquads or set_json is not None \
            or delete_json is not None
        if cond and mutations and not legacy:
            raise ValueError(
                "cond applies to the set_/del_ args; with mutations=[...] "
                "put the cond inside each Mutation")
        own = txn is None
        if txn is None:
            txn = self.new_txn()
        muts = list(mutations) if mutations else []
        if legacy:
            muts.append(Mutation(set_nquads=set_nquads,
                                 del_nquads=del_nquads,
                                 set_json=set_json,
                                 delete_json=delete_json, cond=cond))

        try:
            queries_json: dict = {}
            ex = None
            if query:
                from dgraph_tpu_torch.query.executor import Executor

                parsed = gql_parse(query, variables)
                ex = Executor(self, txn.start_ts, ctx=ctx)
                queries_json = ex.run(parsed)

            applied = False
            for mut in muts:
                if ctx is not None:
                    ctx.check("mutate")
                if not self._cond_holds(mut.cond, ex):
                    continue
                nqs: list[tuple[NQuad, bool]] = []
                if mut.set_nquads:
                    nqs += [(n, False) for n in parse_rdf(mut.set_nquads)]
                if mut.set_json is not None:
                    nqs += [(n, False)
                            for n in parse_json_mutation(mut.set_json)]
                if mut.del_nquads:
                    nqs += [(n, True) for n in parse_rdf(mut.del_nquads)]
                if mut.delete_json is not None:
                    nqs += [(n, True) for n in
                            parse_json_mutation(mut.delete_json, delete=True)]
                if ex is not None:
                    nqs = self._substitute_vars(nqs, ex)
                self._stage(txn, nqs)
                applied = True
            if ctx is not None:
                # last pre-commit boundary: an expired/cancelled
                # request must not commit work its client abandoned
                ctx.check("commit")
        except Exception:
            if own:
                self.discard(txn)  # don't leak the ts in the oracle
            raise
        if commit_now or own:
            if applied or not query:
                self.commit(txn)
            else:
                self.discard(txn)  # all conds failed: nothing to commit
        out = {"uids": {k[2:]: hex(v) for k, v in txn.uid_map.items()
                        if k.startswith("_:")}}
        if query:
            out["queries"] = queries_json
        return out

    def _cond_holds(self, cond: str, ex) -> bool:
        """Evaluate an @if condition over the upsert query's variables.
        The reference restricts conds to boolean combinations of
        eq/le/lt/ge/gt over len(v) (edgraph/server.go checkIfDeletingAcl →
        gql cond validation)."""
        from dgraph_tpu_torch.gql.parser import parse_cond

        ft = parse_cond(cond)
        if ft is None:
            return True
        if ex is None:
            raise ValueError("@if condition requires an upsert query block")
        return self._eval_cond_tree(ft, ex)

    def _eval_cond_tree(self, ft, ex) -> bool:
        if ft.op == "and":
            return all(self._eval_cond_tree(c, ex) for c in ft.children)
        if ft.op == "or":
            return any(self._eval_cond_tree(c, ex) for c in ft.children)
        if ft.op == "not":
            return not self._eval_cond_tree(ft.children[0], ex)
        fn = ft.func
        if fn is None or not fn.is_len_var or not fn.needs_var:
            raise ValueError(
                "@if supports eq/le/lt/ge/gt over len(v) expressions")
        name = fn.needs_var[0].name
        if name in ex.uid_vars:
            n = len(ex.uid_vars[name])
        elif name in ex.value_vars:
            n = len(ex.value_vars[name])
        else:
            n = 0
        want = int(fn.args[0].value)
        return {"eq": n == want, "le": n <= want, "lt": n < want,
                "ge": n >= want, "gt": n > want}[fn.name]

    @staticmethod
    def _uid_ref_var(ref: str) -> Optional[str]:
        if ref.startswith("uid(") and ref.endswith(")"):
            return ref[4:-1]
        return None

    def _substitute_vars(self, nqs: list[tuple[NQuad, bool]], ex
                         ) -> list[tuple[NQuad, bool]]:
        """Expand uid(v)/val(v) references against the upsert query's
        variables. uid(v) fans out (cross product when both subject and
        object are vars); an empty var drops the nquad; val(v) resolves
        per concrete subject uid (ref edgraph/server.go:503
        updateValInMutations, :511 updateUIDInMutations)."""
        out: list[tuple[NQuad, bool]] = []
        for nq, is_del in nqs:
            svar = self._uid_ref_var(nq.subject)
            subjects = [hex(int(u)) for u in ex.uid_vars.get(svar, [])] \
                if svar else [nq.subject]
            ovar = self._uid_ref_var(nq.object_id) if nq.object_id else None
            objects = [hex(int(u)) for u in ex.uid_vars.get(ovar, [])] \
                if ovar else [nq.object_id]
            for s in subjects:
                for o in objects:
                    sub = _dc_replace(nq, subject=s, object_id=o)
                    if nq.val_var:
                        vmap = ex.value_vars.get(nq.val_var, {})
                        v = vmap.get(int(s, 0)) if not s.startswith("_:") \
                            else None
                        if v is None:
                            continue
                        sub.object_value = v
                        sub.val_var = ""
                    out.append((sub, is_del))
        return out

    def _resolve_uid(self, txn: Txn, ref: str) -> int:
        if ref.startswith("_:"):
            uid = txn.uid_map.get(ref)
            if uid is None:
                uid, _ = self.coordinator.assign_uids(1)
                txn.uid_map[ref] = uid
            return uid
        try:
            uid = int(ref, 0)
        except ValueError as e:
            raise ValueError(
                f"subject/object must be a uid (0x..), blank node (_:x) "
                f"or integer, got {ref!r}") from e
        if uid == 0:
            raise ValueError("uid 0 is not allowed")
        self.coordinator.bump_uids(uid)
        return uid

    def _stage(self, txn: Txn, nqs: list[tuple[NQuad, bool]]):
        if txn.done:
            raise TxnAborted("transaction already finished")
        for nq, is_del in nqs:
            if nq.predicate == "*":
                # expand incrementally so sets earlier in this same batch
                # are covered by the wildcard too
                for enq, edel in self._expand_star_pred(txn, nq, is_del):
                    self._stage_one(txn, enq, edel)
            else:
                self._stage_one(txn, nq, is_del)

    def _stage_one(self, txn: Txn, nq: NQuad, is_del: bool):
        pred = nq.predicate
        src = self._resolve_uid(txn, nq.subject)
        tab = self._tablet_for(pred, nq)
        if nq.star:
            if not is_del:
                raise ValueError("* object only allowed in delete")
            op = EdgeOp("del_all", src)
        elif nq.object_id:
            if tab.schema.value_type != TypeID.UID:
                raise ValueError(
                    f"predicate {pred!r} is not a uid predicate")
            dst = self._resolve_uid(txn, nq.object_id)
            op = EdgeOp("del" if is_del else "set", src, dst=dst,
                        facets=nq.facets)
        else:
            val = nq.object_value
            if tab.schema.value_type not in (TypeID.DEFAULT,):
                val = convert(val, tab.schema.value_type)
            op = EdgeOp("del" if is_del else "set", src,
                        posting=Posting(val, nq.lang, nq.facets))
        txn.staged.append((pred, op))
        txn.conflict_keys.add(self._conflict_key(tab, op))

    def _expand_star_pred(self, txn: Txn, nq: NQuad, is_del: bool):
        """`S * *` deletes every predicate S carries (ref
        query/mutation.go:54 expandEdges on x.Star predicate). Expansion
        reads the txn's own snapshot (start_ts) plus everything staged so
        far in this txn — the reference reads through the LocalCache."""
        if not (is_del and nq.star):
            raise ValueError(
                "'*' predicate is only allowed in a `S * *` delete")
        src = self._resolve_uid(txn, nq.subject)
        preds = {p for p, tab in self.tablets.items()
                 if tab.count_of(src, txn.start_ts)}
        preds.update(p for p, op in txn.staged
                     if op.src == src and op.op == "set")
        return [(_dc_replace(nq, predicate=p), is_del)
                for p in sorted(preds)]

    def _conflict_key(self, tab: Tablet, op: EdgeOp) -> int:
        """Ref posting/index.go:305 addMutationHelper conflict keys:
        default (pred, src); @upsert indexed preds conflict on
        (pred, token) so concurrent same-value inserts collide;
        @noconflict opts out."""
        if tab.schema.noconflict:
            return _fp(tab.pred, "noconflict")
        if tab.schema.upsert and op.posting is not None:
            toks = tab._tokens(op.posting)
            if toks:
                return _fp(tab.pred, toks[0])
        return _fp(tab.pred, op.src)

    def _tablet_for(self, pred: str, nq: NQuad | None = None) -> Tablet:
        tab = self.tablets.get(pred)
        if tab is None:
            ps = self.schema.get(pred)
            if ps is None:
                # mutations define schema on the fly (ref
                # worker/mutation.go runSchemaMutation for new preds)
                tid = TypeID.UID if (nq is not None and nq.object_id) \
                    else (nq.object_value.tid if nq and nq.object_value
                          else TypeID.DEFAULT)
                if tid not in (TypeID.UID,):
                    tid = {TypeID.INT: TypeID.INT,
                           TypeID.FLOAT: TypeID.FLOAT,
                           TypeID.BOOL: TypeID.BOOL,
                           TypeID.DATETIME: TypeID.DATETIME,
                           TypeID.GEO: TypeID.GEO,
                           TypeID.FLOAT32VECTOR: TypeID.FLOAT32VECTOR,
                           }.get(tid, TypeID.DEFAULT)
                # implicit uid predicates default to LIST (the
                # reference's schemaless edges are [uid]; only an
                # explicit `p: uid .` is single-valued and emits as
                # one object — query0_test.go TestGetNonListUidPredicate)
                ps = PredicateSchema(pred, value_type=tid,
                                     list_=tid == TypeID.UID)
                self.schema.set_predicate(ps)
            self.coordinator.should_serve(pred)
            tab = Tablet(pred, ps, device=self.device)
            self.tablets[pred] = tab
        return tab

    def xstage_ops(self, start_ts: int, nqs) -> tuple[list, set, dict]:
        """Build one group's fragment of a cross-group transaction at an
        externally issued global start_ts WITHOUT applying anything:
        returns (staged (pred, EdgeOp) list, conflict keys, touched
        schemas). Blank nodes must already be resolved to real uids by
        the coordinator — per-group blank allocation would tear one
        entity across uid spaces. Ref worker/mutation.go:472
        populateMutationMap building per-group fragments."""
        for nq, _ in nqs:
            if nq.subject.startswith("_:") or \
                    (nq.object_id or "").startswith("_:"):
                raise ValueError(
                    "cross-group stage requires pre-resolved uids "
                    f"(got blank node in {nq.subject!r} "
                    f"{nq.predicate!r} {nq.object_id!r})")
        self.coordinator.observe_ts(start_ts)
        txn = self.new_txn_at(start_ts)
        try:
            self._stage(txn, nqs)
            schemas = {p: self.schema.get_or_default(p).describe()
                       for p in {pred for pred, _ in txn.staged}}
            return list(txn.staged), set(txn.conflict_keys), schemas
        finally:
            self.discard(txn)

    def commit(self, txn: Txn) -> int:
        with _span("commit", start_ts=txn.start_ts,
                   edges=len(txn.staged)):
            commit_ts = self.commit_reserve(txn)
            return self.commit_apply(txn, commit_ts)

    def commit_reserve(self, txn: Txn) -> int:
        """Conflict-check the txn at the oracle and obtain its commit
        ts WITHOUT applying. Split from commit_apply so a clustered
        server can drain already-decided cross-group fragments (all of
        which carry a LOWER commit ts — the oracle assigns ts
        monotonically and decides serially) between reservation and
        apply, reproducing the reference's single-log apply order
        (ref worker/draft.go:435 processApplyCh)."""
        if txn.done:
            raise TxnAborted("transaction already finished")
        try:
            commit_ts = self.coordinator.commit(txn._state, txn.conflict_keys)
        except TxnAborted:
            txn.done = True
            metrics.inc_counter("dgraph_txn_aborts_total")
            raise
        metrics.inc_counter("dgraph_num_mutations_total")
        metrics.inc_counter("dgraph_num_edges_total", len(txn.staged))
        txn.done = True
        return commit_ts

    def commit_apply(self, txn: Txn, commit_ts: int) -> int:
        """Expand and apply a reserved commit. MUST eventually run
        after a successful commit_reserve: the oracle has already
        recorded the decision."""
        expanded = self._expand_ops(commit_ts, txn.staged)
        for pred, ops in expanded.items():
            self._tablet_for(pred).apply(commit_ts, ops)
        if self.wal or self.on_record:
            # log the *expanded* ops (incl. synthesized old-token deletes)
            # plus the schema of every touched predicate, so replay is
            # self-contained even for schema created on the fly
            schemas = {p: self.schema.get_or_default(p).describe()
                       for p in expanded}
            self._log_record(("commit", commit_ts,
                              [(p, op) for p, ops in expanded.items()
                               for op in ops], schemas))
        # CDC tail AFTER the applies, from the same expanded ops the
        # record carries: followers tap the identical dict shape in
        # apply_record, so offsets agree across replicas
        self.cdc.append(commit_ts, expanded)
        return commit_ts

    def discard(self, txn: Txn):
        if not txn.done:
            self.coordinator.abort(txn._state)
            txn.done = True

    def _expand_ops(self, commit_ts: int, staged: list[tuple[str, EdgeOp]]
                    ) -> dict[str, list[EdgeOp]]:
        """The apply-loop expansion (ref worker/draft.go:435 processApplyCh
        → runMutation): single-value overwrites become del(old)+set(new)
        so index overlays stay exact. Tracks values written earlier in the
        *same* transaction so a double-set deletes the intermediate
        value's tokens too."""
        by_pred: dict[str, list[EdgeOp]] = {}
        for pred, op in staged:
            by_pred.setdefault(pred, []).append(op)
        out: dict[str, list[EdgeOp]] = {}
        for pred, ops in by_pred.items():
            tab = self._tablet_for(pred)
            expanded: list[EdgeOp] = []
            pending: dict[tuple[int, str], Posting] = {}  # (src, lang)
            wiped: set[int] = set()
            for op in ops:
                if (op.op == "set" and op.posting is not None
                        and not tab.schema.list_):
                    key = (op.src, op.posting.lang)
                    if key in pending:
                        old = [pending[key]]
                    elif op.src in wiped:
                        old = []
                    else:
                        old = [p for p in
                               # pre-image read: the overwrite
                               # expansion must see state strictly
                               # below the commit it is applying
                               tab.get_postings(op.src, commit_ts - 1)  # dglint: disable=DG11 (pre-image read)
                               if p.lang == op.posting.lang]
                    for p in old:
                        expanded.append(EdgeOp("del", op.src, posting=p))
                    pending[key] = op.posting
                elif op.op == "del_all":
                    wiped.add(op.src)
                    pending = {k: v for k, v in pending.items()
                               if k[0] != op.src}
                expanded.append(op)
            out[pred] = expanded
        return out

    def _log_record(self, rec):
        if self.wal:
            self.wal.append(rec)
        if self.on_record:
            self.on_record(rec)

    def apply_record(self, rec) -> int:
        """Applies one durable mutation record (WAL replay and the Raft
        apply loop share this path — ref worker/draft.go:435
        processApplyCh/applyCommitted). Returns the commit ts the record
        carried, 0 for schema ops."""
        kind = rec[0]
        if kind in ("alter", "drop_all", "drop_attr", "import_tablet",
                    "move_drop", "split_prune"):
            self._bump_schema_epoch()
        if kind == "alter":
            preds, types = self.schema.apply_text(rec[1])
            for ps in preds:
                t = self.tablets.get(ps.predicate)
                if t:
                    t.schema = ps
                    t.rebuild_index()
                    t.rebuild_reverse()
            return 0
        if kind == "drop_all":
            self.tablets.clear()
            self.schema = SchemaState()
            self.cdc.clear()
            self.moved_out.clear()
            self.split_partial.clear()
            return 0
        if kind == "drop_attr":
            dropped = self.tablets.pop(rec[1], None)
            if dropped is not None:
                self.device_cache.drop_tablet(dropped)
            self.schema.delete_predicate(rec[1])
            self.cdc.drop(rec[1])
            self.split_partial.discard(rec[1])
            return 0
        if kind == "import_tablet":
            # predicate move landing on the destination group
            # (ref worker/predicate_move.go:178 ReceivePredicate);
            # the whole tablet arrives as one replicated record so
            # every group replica installs identical state
            _, pred, payload = rec
            from dgraph_tpu_torch.storage.snapshot import restore_tablet
            if not self.schema.has(pred):
                self.schema.apply_text(payload["schema"])
            tab = restore_tablet(pred, self.schema.get_or_default(pred),
                                 payload["tablet"], self.device)
            old = self.tablets.get(pred)
            if old is not None:
                self.device_cache.drop_tablet(old)
            self.tablets[pred] = tab
            self.moved_out.pop(pred, None)  # serving again (moved back)
            if payload.get("shard") is not None:
                # a shard import: this member now holds a RANGE of the
                # predicate, not the whole — single-group queries must
                # misroute typed (split tombstone)
                self.split_partial.add(pred)
            else:
                self.split_partial.discard(pred)
            self.coordinator.should_serve(pred)
            self.coordinator.bump_uids(payload.get("max_uid", 0))
            # CDC floor at the shipped base: commits <= max_commit_ts
            # live in the installed state, commits after it arrive as
            # ("move_delta", ...) records which append to the log with
            # the SAME zero-global offsets the source derived — a
            # subscriber's offset survives the move
            self.cdc.reset_floor(pred, tab.max_commit_ts)
            return payload.get("max_ts", 0)
        if kind == "move_delta":
            # catch-up batches of a live tablet move landing on the
            # destination (whole commits, ascending ts — the
            # cdc/changelog.read_raw contract). Re-delivered batches
            # (a mover's retry after a crash) are skipped by the
            # max_commit_ts guard, which is replicated state, so every
            # group member skips identically.
            _, pred, batches = rec
            tab = self._tablet_for(pred)
            top = 0
            for ts, ops in batches:
                ts = int(ts)
                if ts <= tab.max_commit_ts:
                    continue
                ops = list(ops)
                tab.apply(ts, ops)
                self.cdc.append(ts, {pred: ops})
                uids = [op.src for op in ops] + \
                       [op.dst for op in ops if op.dst]
                if uids:
                    self.coordinator.bump_uids(max(uids))
                top = ts
            return top
        if kind == "move_drop":
            # source-side cleanup after the ownership flip: drop the
            # moved copy AND tombstone the predicate so a stale-routed
            # request gets a typed misroute, never empty results
            _, pred, dst = rec
            dropped = self.tablets.pop(pred, None)
            if dropped is not None:
                self.device_cache.drop_tablet(dropped)
            self.schema.delete_predicate(pred)
            self.cdc.drop(pred)
            self.split_partial.discard(pred)
            self.moved_out[pred] = int(dst)
            while len(self.moved_out) > 256:  # bounded, oldest-first
                self.moved_out.pop(next(iter(self.moved_out)))
            return 0
        if kind == "split_prune":
            # source-side cleanup after a SPLIT flip: keep only the
            # rows outside the moved hash range (pure function of
            # replicated tablet state — every member prunes identically)
            _, pred, nshards, shard = rec
            tab = self.tablets.get(pred)
            if tab is None:
                return 0
            from dgraph_tpu_torch.cluster.shard import shard_view
            pruned = shard_view(tab, int(nshards), int(shard),
                                invert=True)
            pruned.touches = tab.touches
            self.device_cache.drop_tablet(tab)
            self.tablets[pred] = pruned
            self.split_partial.add(pred)
            return 0
        if kind == "commit":
            _, commit_ts, staged, schemas = rec
            # restore on-the-fly schema before creating tablets
            for pred, desc in schemas.items():
                if not self.schema.has(pred):
                    self.schema.apply_text(desc)
            by_pred: dict[str, list[EdgeOp]] = {}
            for pred, op in staged:
                by_pred.setdefault(pred, []).append(op)
            conflict_keys: set = set()
            for pred, ops in by_pred.items():
                for op in ops:
                    conflict_keys.add(
                        self._conflict_key(self._tablet_for(pred), op))
            # ops were expanded before logging: apply verbatim (the
            # leader already counted this commit's metrics at commit
            # time, so replay must not)
            self._apply_decided(commit_ts, by_pred, conflict_keys,
                                staged, count_metrics=False)
            self.cdc.append(commit_ts, by_pred)
            return commit_ts
        if kind == "xstage":
            # one group's fragment of a cross-group txn: hold it
            # pending until the Zero oracle's decision arrives as an
            # xfinalize record (ref worker/mutation.go staged proposals)
            _, start_ts, staged, schemas, keys = rec
            for pred, desc in schemas.items():
                if not self.schema.has(pred):
                    self.schema.apply_text(desc)
            self.pending_txns[int(start_ts)] = (list(staged), list(keys))
            return int(start_ts)
        if kind == "xfinalize":
            _, start_ts, commit_ts = rec
            pend = self.pending_txns.pop(int(start_ts), None)
            if pend is None or not commit_ts:
                return int(commit_ts) if commit_ts else 0
            staged, keys = pend
            expanded = self._expand_ops(commit_ts, staged)
            self._apply_decided(commit_ts, expanded,
                                {int(k) for k in keys}, staged)
            self.cdc.append(commit_ts, expanded)
            return int(commit_ts)
        raise ValueError(f"unknown record kind {kind!r}")

    def _apply_decided(self, commit_ts: int,
                       by_pred: dict[str, list[EdgeOp]],
                       conflict_keys: set, staged: list,
                       count_metrics: bool = True) -> None:
        """Shared tail of applying a decided commit (single-group
        replayed record or cross-group finalize): tablet apply, oracle
        conflict-window mirror (ref posting/oracle.go ProcessDelta — a
        replica that later becomes leader must abort open txns that
        raced this write), uid high-water mark, metrics."""
        for pred, ops in by_pred.items():
            self._tablet_for(pred).apply(commit_ts, ops)
        self.coordinator.register_commit(conflict_keys, commit_ts)
        uids = [op.src for _, op in staged] + \
               [op.dst for _, op in staged if op.dst]
        if uids:
            self.coordinator.bump_uids(max(uids))
        if count_metrics:
            metrics.inc_counter("dgraph_num_mutations_total")
            metrics.inc_counter("dgraph_num_edges_total", len(staged))

    def close(self):
        """Flush and close the WAL (the reference's alpha shutdown
        closes its Badger stores); the engine object stays usable in
        memory but stops persisting."""
        if self._coststore_path is not None:
            try:
                coststore.save(self._coststore_path)
            except OSError:
                pass  # stats are advisory; shutdown must not fail
            self._coststore_path = None
        if self.prefetcher is not None:
            # the decode workers end BEFORE the store closes: close
            # cancels the queued decodes and waits for the running ones
            self.prefetcher.close()
            self.prefetcher = None
        if self.tablet_store is not None:
            self.tablets.flush_all()
            self.tablet_store.close()
            self.tablet_store = None
            # a closed native store raises ClosedError on every call:
            # degrade the TabletMap to a plain dict of whatever is
            # resident — stored-only predicates are no longer reachable
            # after close (a lazy load through a TabletMap a query
            # thread still holds finds them absent, TabletMap.get)
            self.tablets = {p: t for p, t in dict.items(self.tablets)}
        if self.wal:
            self.wal.close()
            self.wal = None

    def checkpoint(self):
        """Store-backed mode: persist every resident tablet + schema
        and compact the store (one snapshot, an empty log). The
        durability point a serving deployment calls periodically."""
        if self.tablet_store is None:
            raise RuntimeError("checkpoint() needs store_dir")
        self.tablets.flush_all()
        self.tablet_store.compact()
        if self._coststore_path is not None:
            try:
                coststore.save(self._coststore_path)
            except OSError:
                pass

    def fast_forward_ts(self, max_ts: int):
        """Advance the ts counter past replayed/replicated commits."""
        self.coordinator.observe_ts(max_ts)

    def _replay(self):
        max_ts = 0
        for rec in self.wal.replay():
            max_ts = max(max_ts, self.apply_record(rec))
        if max_ts:
            self.fast_forward_ts(max_ts)

    # ------------------------------------------------------------------
    # Query (ref edgraph/server.go:634 Query -> query.Process)
    # ------------------------------------------------------------------

    def _result_cache_probe(self, q, variables, txn, best_effort,
                            read_ts, explain, mode):
        """(cache key, predicate footprint) when this request may
        serve from / fill the result cache, else (None, None).

        Eligible: best-effort reads (watermark reads, and the
        follower-read path's explicitly pinned `read_ts` — the shared
        per-window grant makes those keys collide across requests,
        which is the point). Bypassed: txn reads (their snapshot is
        the txn's, not a shared class), strict reads (they allocate a
        fresh ts), explain (annotations vary per execution), schema
        introspection, expand() blocks (the predicate footprint is
        unknowable from the skeleton) and unhashable params."""
        rc = self.result_cache
        if rc is None or txn is not None or explain is not None \
                or not best_effort or self.plan_cache is None:
            return None, None
        from dgraph_tpu_torch.engine.result_cache import query_predicates
        from dgraph_tpu_torch.query.plan import skeleton

        parsed, _struct, skel = self.plan_cache.parse(q, variables)
        if parsed.schema_request is not None \
                or getattr(parsed, "explain", ""):
            return None, None

        def has_expand(g) -> bool:
            return bool(getattr(g, "expand", "")) \
                or any(has_expand(c) for c in g.children)

        if any(has_expand(gq) for gq in parsed.queries):
            return None, None
        preds = {p.lstrip("~") for p in query_predicates(parsed)}
        if not preds:
            return None, None  # uid-only: nothing to invalidate on
        struct, params = skeleton(parsed)
        try:
            hash(params)
        except TypeError:
            return None, None
        kind = ("ts", int(read_ts)) if read_ts is not None else ("be",)
        return (mode, skel, struct, params, kind,
                self.schema_epoch), preds

    def _result_cache_gen(self, key):
        """Fill-race guard generation for a ("be",) keyed entry: a
        result computed BEFORE a concurrent commit must not be stored
        AFTER that commit's invalidation swept the cache — put()
        discards the fill when the generation moved. ("ts", T) entries
        are immutable by MVCC; no guard needed."""
        return self.result_cache.generation \
            if key is not None and key[4][0] == "be" else None

    def query(self, q: str, variables: dict | None = None,
              txn: Optional[Txn] = None, best_effort: bool = True,
              read_ts: Optional[int] = None, ctx=None,
              explain: Optional[str] = None) -> dict:
        """`read_ts` pins the MVCC snapshot to an externally issued
        timestamp (a zero-global ts for cross-group reads); otherwise
        best_effort reads at max_assigned and strict reads allocate.
        `ctx` (utils/reqctx.RequestContext) carries the request's
        deadline/cancellation into the executor AND its trace ids:
        spans opened anywhere below join the request's trace.
        `explain` ("plan" | "analyze", or the in-query `@explain`
        flag) attaches the compiled plan tree — with stats-estimated
        rows, and for analyze the observed rows/durations/tier
        counters — under `extensions.explain`. The DATA payload is
        byte-identical with or without it: explain annotates a normal
        execution, it never changes one."""
        import copy as _copy
        t_in = time.perf_counter_ns()
        rc_key, rc_fp = self._result_cache_probe(
            q, variables, txn, best_effort, read_ts, explain, "py")
        if rc_key is not None:
            hit = self.result_cache.get(rc_key)
            if hit is not None:
                self._result_cache_hit_metrics(
                    ctx, rc_key[1], time.perf_counter_ns() - t_in)
                return _copy.deepcopy(hit)  # callers may mutate
        rc_gen = self._result_cache_gen(rc_key)
        with bind_request(ctx), _span("query") as sp:
            ex, done, lat, read_ts, expinfo = self._query_run(
                q, variables, txn, best_effort, read_ts, ctx, sp,
                explain=explain)
            try:
                with coststore.bind_plan(_skel_of(ex.plan)), \
                        _span("encode") as esp:
                    t0 = time.perf_counter_ns()
                    data = ex.emit(done)
                    if ex.parsed is not None \
                            and ex.parsed.schema_request is not None:
                        data["schema"] = self._schema_rows(
                            ex.parsed.schema_request)
                    lat.encoding_ns = time.perf_counter_ns() - t0
                    esp["encode_us"] = lat.encoding_ns // 1000
            finally:
                self.coordinator.unpin_read(read_ts)
            expl = None
            if expinfo is not None:
                from dgraph_tpu_torch.query.explain import build_explain
                expl = build_explain(self, ex, done, expinfo)
        self._query_metrics(lat, ctx, ex.plan)
        ext = {"latency": lat.as_dict(),
               "server_latency": lat.server_latency(),
               "txn": {"start_ts": read_ts}}
        if expl is not None:
            ext["explain"] = expl
        out = {"data": data, "extensions": ext}
        if rc_key is not None:
            # stored verbatim (deep-copied): a later hit serves the
            # exact response this execution produced
            self.result_cache.put(rc_key, rc_fp, _copy.deepcopy(out),
                                  gen=rc_gen)
        return out

    def _schema_rows(self, req: dict) -> list[dict]:
        """`schema {}` introspection rows, the reference's response
        shape: one object per predicate with falsy fields omitted and
        an optional field selection (ref query schema nodes)."""
        from dgraph_tpu_torch.models.types import type_name
        want = set(req.get("preds") or ())
        fields = set(req.get("fields") or ())
        rows = []
        for pred in sorted(self.schema.predicates()):
            if want and pred not in want:
                continue
            ps = self.schema.get_or_default(pred)
            row: dict = {"predicate": pred,
                         "type": type_name(ps.value_type)}
            if ps.indexed:
                row["index"] = True
                row["tokenizer"] = list(ps.tokenizers)
            if ps.reverse:
                row["reverse"] = True
            if ps.count:
                row["count"] = True
            if ps.list_:
                row["list"] = True
            if ps.upsert:
                row["upsert"] = True
            if ps.lang:
                row["lang"] = True
            if fields:
                row = {k: v for k, v in row.items()
                       if k == "predicate" or k in fields}
            rows.append(row)
        return rows

    def _query_run(self, q, variables, txn, best_effort, read_ts,
                   ctx=None, sp=None, explain=None):
        """Shared query front half: parse, read-ts resolution,
        execution — everything up to (but excluding) emission, which
        query() and query_json() do differently. `sp` is the
        enclosing "query" span's attr dict (phase timings land there
        so the trace view shows the breakdown inline). Returns an
        extra `expinfo` dict (None unless this request asked for
        EXPLAIN via the `explain` kwarg or the parsed `@explain`
        flag): the trace id, the pre-execution counter snapshot and
        the plan-cache outcome query/explain.py assembles from."""
        from dgraph_tpu_torch.query.executor import Executor
        from dgraph_tpu_torch.utils import tracing as _tracing

        lat = Latency()
        plan = None
        cache_info: dict = {}
        with _span("parse"):
            t0 = time.perf_counter_ns()
            if self.plan_cache is not None:
                # cached parse + compiled plan: a warm same-skeleton
                # request binds its literals and skips the parser and
                # the per-stage re-derivation entirely
                parsed, plan = self.plan_cache.lookup(
                    self, q, variables, info=cache_info)
            else:
                parsed = gql_parse(q, variables)
            lat.parsing_ns = time.perf_counter_ns() - t0
        if ctx is not None:
            ctx.check("parse")

        if explain not in (None, "plan", "analyze"):
            raise ValueError(
                f"explain must be 'plan' or 'analyze', got {explain!r}")
        # transport flag and in-query directive combine by taking the
        # STRONGER mode: ?explain=true must never silently downgrade a
        # body that asked for @explain(analyze: true)
        doc_mode = getattr(parsed, "explain", "") or None
        rank = {None: 0, "plan": 1, "analyze": 2}
        mode = explain if rank[explain] >= rank[doc_mode] else doc_mode
        expinfo = None
        if mode is not None:
            cur = _tracing.current()
            expinfo = {"mode": mode,
                       "trace_id": cur[0] if cur is not None else "",
                       "counters_before": metrics.counters_snapshot(),
                       "cache": dict(cache_info)}

        t0 = time.perf_counter_ns()
        if read_ts is not None:
            pass  # pinned snapshot
        elif txn is not None:
            read_ts = txn.start_ts
        elif best_effort:
            read_ts = self.coordinator.max_assigned()
        else:
            read_ts = self.coordinator.next_ts()
        lat.assign_ts_ns = time.perf_counter_ns() - t0

        # hold the rollup watermark for the query's duration
        # (execution AND emission — both read tablets at read_ts);
        # callers unpin in their finally blocks
        self.coordinator.pin_read(read_ts)
        # the coststore attributes every stage span inside to this
        # request's plan skeleton ("" on the interpreted path)
        with coststore.bind_plan(_skel_of(plan)), _span("execute"):
            t0 = time.perf_counter_ns()
            try:
                ex = Executor(self, read_ts, ctx=ctx, plan=plan)
                done = ex.execute(parsed)
            except BaseException:
                self.coordinator.unpin_read(read_ts)
                raise
            lat.processing_ns = time.perf_counter_ns() - t0
        if sp is not None:
            sp["read_ts"] = read_ts
            sp["blocks"] = len(parsed.queries)
            sp["parse_us"] = lat.parsing_ns // 1000
            sp["process_us"] = lat.processing_ns // 1000
        return ex, done, lat, read_ts, expinfo

    def _query_metrics(self, lat: Latency, ctx=None, plan=None):
        metrics.inc_counter("dgraph_num_queries_total")
        metrics.observe("dgraph_query_latency_ms",
                        (lat.parsing_ns + lat.processing_ns
                         + lat.encoding_ns) / 1e6)
        sl = lat.server_latency()
        reqlog.record("query",
                      trace_id=ctx.trace_id if ctx is not None else "",
                      latency_ms=sl["total_ns"] / 1e6, breakdown=sl,
                      plan_key=_skel_of(plan),
                      tenant=getattr(ctx, "tenant", ""))

    def _result_cache_hit_metrics(self, ctx, skel: str,
                                  total_ns: int):
        """A cache hit is still a served query: it must land in the
        query counters and the request log (tenant included), or the
        hottest queries vanish from observability exactly when the
        cache starts working."""
        metrics.inc_counter("dgraph_num_queries_total")
        metrics.observe("dgraph_query_latency_ms", total_ns / 1e6)
        sl = {"parsing_ns": 0, "processing_ns": 0,
              "encoding_ns": 0, "total_ns": int(total_ns)}
        reqlog.record("query",
                      trace_id=ctx.trace_id if ctx is not None else "",
                      latency_ms=total_ns / 1e6, breakdown=sl,
                      plan_key=skel,
                      tenant=getattr(ctx, "tenant", ""))

    def query_json(self, q: str, variables: dict | None = None,
                   txn: Optional[Txn] = None, best_effort: bool = True,
                   read_ts: Optional[int] = None, ctx=None,
                   explain: Optional[str] = None) -> str:
        """query() with the serialized-response fast path: the full
        {"data": ..., "extensions": ...} body as ONE JSON string, with
        flat uid+scalar blocks encoded by the native columnar row
        serializer instead of per-uid dict building + json.dumps
        (ref query/outputnode.go fastJsonNode — a documented reference
        hot loop). The serving layers (HTTP/gRPC) call this; library
        users who want Python objects keep query(). `explain` as in
        query(): the `data` bytes are identical either way, the plan
        tree rides in `extensions.explain`."""
        t_in = time.perf_counter_ns()
        rc_key, rc_fp = self._result_cache_probe(
            q, variables, txn, best_effort, read_ts, explain, "json")
        if rc_key is not None:
            hit = self.result_cache.get(rc_key)
            if hit is not None:
                self._result_cache_hit_metrics(
                    ctx, rc_key[1], time.perf_counter_ns() - t_in)
                return hit  # the stored string: byte-identical
        rc_gen = self._result_cache_gen(rc_key)
        with bind_request(ctx), _span("query") as sp:
            ex, done, lat, read_ts, expinfo = self._query_run(
                q, variables, txn, best_effort, read_ts, ctx, sp,
                explain=explain)
            try:
                with coststore.bind_plan(_skel_of(ex.plan)), \
                        _span("encode") as esp:
                    t0 = time.perf_counter_ns()
                    data_json = ex.emit_json(done)
                    if ex.parsed is not None \
                            and ex.parsed.schema_request is not None:
                        rows = _json.dumps(
                            self._schema_rows(ex.parsed.schema_request),
                            separators=(",", ":"))
                        data_json = ('{"schema":' + rows + "}"
                                     if data_json == "{}" else
                                     data_json[:-1] + ',"schema":'
                                     + rows + "}")
                    lat.encoding_ns = time.perf_counter_ns() - t0
                    esp["encode_us"] = lat.encoding_ns // 1000
            finally:
                self.coordinator.unpin_read(read_ts)
            expl = None
            if expinfo is not None:
                from dgraph_tpu_torch.query.explain import build_explain
                expl = build_explain(self, ex, done, expinfo)
        self._query_metrics(lat, ctx, ex.plan)
        ext_obj: dict = {"latency": lat.as_dict(),
                         "server_latency": lat.server_latency(),
                         "txn": {"start_ts": read_ts}}
        if expl is not None:
            ext_obj["explain"] = expl
        ext = _json.dumps(ext_obj)
        body = '{"data":' + data_json + ',"extensions":' + ext + "}"
        if rc_key is not None:
            self.result_cache.put(rc_key, rc_fp, body, gen=rc_gen)
        return body

    # ------------------------------------------------------------------
    # Bulk traversal API: the device-first equivalent of @recurse for
    # analytical workloads (ref query/recurse.go semantics, level sets
    # instead of nested JSON).
    # ------------------------------------------------------------------


    # ------------------------------------------------------------------
    # Bulk traversal API: the device-first equivalent of @recurse for
    # analytical workloads (ref query/recurse.go semantics, level sets
    # instead of nested JSON).
    # ------------------------------------------------------------------

    def bfs(self, pred: str, seeds, depth: int,
            dedup: bool = True) -> list[np.ndarray]:
        """Per-level frontier uid arrays reachable from `seeds` via
        `pred`, device-accelerated when the tablet is clean."""
        from dgraph_tpu_torch.engine.device_cache import _MAX_U32, \
            device_bitadjacency
        from dgraph_tpu_torch.ops.bitgraph import bfs_bits_reach

        seeds = np.asarray(sorted(set(int(s) for s in seeds)),
                           dtype=np.uint64)
        tab = self.tablets.get(pred)
        if tab is None:
            return [np.empty(0, np.uint64) for _ in range(depth)]
        read_ts = self.coordinator.max_assigned()
        badj = device_bitadjacency(self, tab, read_ts) \
            if self.prefer_device else None
        if badj is not None:
            lv32 = bfs_bits_reach(
                badj, seeds[seeds <= _MAX_U32].astype(np.uint32), depth,
                dedup)
            return [lv.astype(np.uint64) for lv in lv32]
        # host fallback: same semantics over the MVCC overlay
        levels = []
        visited = seeds
        frontier = seeds
        for _ in range(depth):
            nxt = tab.expand_frontier(frontier, read_ts)
            if dedup:
                nxt = np.setdiff1d(nxt, visited, assume_unique=True)
                visited = np.union1d(visited, nxt)
            levels.append(nxt)
            frontier = nxt
        return levels

    # -- maintenance --

    def export_tablet(self, pred: str) -> dict:
        """One predicate's full state for a tablet move
        (ref worker/predicate_move.go:81 movePredicateHelper streams
        the posting lists; here the rolled-up base ships as one wire
        payload). Refuses to export while committed deltas cannot fold
        (an open txn pins the watermark) — shipping only the base would
        silently drop them once the source drops the tablet."""
        from dgraph_tpu_torch.storage.snapshot import dump_tablet
        tab = self.tablets[pred]
        if tab.dirty():
            tab.rollup(self.fold_watermark())
        if tab.dirty():
            raise RuntimeError(
                f"tablet {pred!r} still has unfolded deltas (an open "
                "transaction pins the rollup watermark); retry when "
                "transactions drain")
        for start_ts, (staged, _keys) in self.pending_txns.items():
            if any(p == pred for p, _ in staged):
                # a cross-group 2PC fragment touches this tablet: the
                # export would ship state WITHOUT it, and its later
                # finalize would land on a tablet no reader routes to —
                # a committed write silently lost. The move retries
                # once the transaction resolves.
                raise RuntimeError(
                    f"tablet {pred!r} has a pending cross-group stage "
                    f"(startTs {start_ts}); retry when it resolves")
        return {
            "schema": tab.schema.describe(),
            "tablet": dump_tablet(tab),
            "max_ts": self.coordinator.max_assigned(),
            "max_uid": self.coordinator._next_uid - 1,
        }

    def export_tablet_move(self, pred: str, nshards: int = 1,
                           shard: Optional[int] = None) -> dict:
        """Move/split snapshot at a catch-up base (the streaming move
        path, ref worker/predicate_move.go streaming batches while the
        source serves). Unlike export_tablet this does NOT require a
        quiesced tablet: the payload carries base + any still-unfolded
        deltas as of `snap_ts` = tab.max_commit_ts, and every commit
        AFTER snap_ts reaches the destination through the CDC raw tail
        (cdc/changelog.read_raw -> ("move_delta", ...) records). With
        `shard` set, only the rows of that hash range ship
        (cluster/shard.shard_view) — the split move's unit."""
        from dgraph_tpu_torch.storage.snapshot import dump_tablet
        tab = self.tablets[pred]
        if tab.dirty():
            tab.rollup(self.fold_watermark())
        view = tab
        if shard is not None:
            from dgraph_tpu_torch.cluster.shard import shard_view
            view = shard_view(tab, nshards, shard)
        return {
            "schema": tab.schema.describe(),
            "tablet": dump_tablet(view),
            "max_ts": self.coordinator.max_assigned(),
            "max_uid": self.coordinator._next_uid - 1,
            "snap_ts": tab.max_commit_ts,
            # shard moves mark the destination split-partial on
            # import: it holds a RANGE, not the whole predicate
            "shard": None if shard is None else int(shard),
            "nshards": int(nshards),
        }

    def device_is_accelerator(self) -> bool:
        """Whether the engine's device is accelerator silicon. On the
        CPU the device plane shares the host's cores, so dispatching
        set algebra or sorts there can only lose to numpy, and the
        RTT-based cost model can't see that. device_min_edges <= 1
        still force-overrides."""
        return self.device.type != "cpu"

    def device_dispatch_seconds(self) -> float:
        """Measured round trip of ONE trivial launch on the engine's
        device and its `.item()` fetch (lazy, cached per process and
        device). This is the executor's device/host tier constant:
        sub-millisecond with a locally attached card, while the host
        cost of a small query is microseconds. Distinct inputs per
        timing launch."""
        key = str(self.device)
        got = _DISPATCH_SECONDS.get(key)
        if got is None:
            xs = [torch.tensor([i], dtype=torch.int32, device=self.device)
                  for i in range(4)]
            (xs[0] + 1).item()  # first launch outside the timing
            got = float("inf")
            for x in xs[1:]:
                t0 = time.perf_counter()
                (x + 1).item()  # the fetch forces the full round trip
                got = min(got, time.perf_counter() - t0)
            _DISPATCH_SECONDS[key] = got
        return got

    def fold_watermark(self, window: int = 0) -> int:
        """Highest ts safe to fold into tablet bases. Below every
        active txn AND below every pending 2PC stage's start_ts: a
        stage decided at zero (hence no longer "active" there) whose
        finalize hasn't landed here yet will apply at some
        commit_ts > its start_ts — folding past that would let the
        base overtake a commit still in flight."""
        wm = self.coordinator.min_active_ts()
        if window:
            wm = min(wm, self.coordinator.max_assigned() - window)
        if self.pending_txns:
            wm = min(wm, min(self.pending_txns) - 1)
        return wm

    def rollup_all(self, window: Optional[int] = None):
        """Fold overlays up to the watermark. `window` (default
        self.rollup_window) keeps the fold that many ts behind the
        newest commit for in-flight pinned readers; pass 0 to fold
        everything foldable (export/offload paths need that)."""
        if window is None:
            window = self.rollup_window
        wm = self.fold_watermark(window)
        for tab in self.tablets.values():
            if tab.dirty():
                tab.rollup(wm)
        self._train_vector_indexes()

    def _train_vector_indexes(self):
        """Rollup hook: (re)train the quantized ANN index of every
        vector tablet whose clean base crossed vec_index_min_rows.
        A tablet whose base_ts did not move keeps its index (the
        cache validates the version); training failures degrade to
        the exact tiers, never to an error."""
        if not self.vec_quantized:
            return
        from dgraph_tpu_torch.models.types import TypeID
        for tab in self.tablets.values():
            if tab.schema.value_type != TypeID.FLOAT32VECTOR:
                continue
            if len(tab.values) < self.vec_index_min_rows:
                continue
            try:
                tab.build_vector_ivf(
                    min_rows=self.vec_index_min_rows,
                    target_recall=self.vec_target_recall)
            except Exception as e:
                from dgraph_tpu_torch.utils.logger import log
                log.error("vector_index_build_failed", pred=tab.pred,
                          error=f"{type(e).__name__}: {e}")

    def build_vector_index(self, pred: str, *, nlist: int | None = None,
                           force: bool = True):
        """Explicitly train the quantized ANN index for one vector
        predicate (operators / tests; rollup trains automatically
        above vec_index_min_rows). Returns the index description or
        None when the tablet is empty."""
        tab = self.tablets.get(pred)
        if tab is None:
            raise ValueError(f"no tablet for predicate {pred!r}")
        ix = tab.build_vector_ivf(
            nlist=nlist, force=force,
            target_recall=self.vec_target_recall)
        return ix.describe() if ix is not None else None

    def state(self) -> dict:
        """Cluster/engine introspection (ref /state handler,
        edgraph/server.go:602). Tablet entries carry the cheap
        always-on stat summary (edges, srcs, bytes, dirty overlay
        ops, query touches) — the reference's zero reports tablet
        sizes the same way (zero/tablet.go:180); the full histograms
        live at /debug/stats."""
        from dgraph_tpu_torch.storage.tabstats import tablet_summary
        return {
            "maxAssigned": self.coordinator.max_assigned(),
            "groups": {str(g): {
                "tablets": {p: tablet_summary(self.tablets[p])
                            for p, gg in self.coordinator.tablets.items()
                            if gg == g and p in self.tablets}}
                for g in self.coordinator.groups},
            "schema": self.schema.describe_all(),
            "deviceCache": self.device_cache.stats(),
            "planCache": self.plan_cache.stats()
            if self.plan_cache is not None else None,
            "schemaEpoch": self.schema_epoch,
        }

    def debug_stats(self) -> dict:
        """The full stats-plane payload backing /debug/stats: every
        resident tablet's statistics (storage/tabstats.py), the
        observed-cost summaries, and the engine cache states. Runs
        WITHOUT any serving/Raft lock: a cold stats cache recomputes
        O(postings) aggregates, and holding the read lock for that
        would (via the rwlock's writer preference) stall every query
        behind one poll. Stats are advisory — concurrent apply/rollup
        racing a tablet's dict iteration is retried, and a tablet
        that stays contended degrades to its cheap summary with
        `"partial": true` rather than an error."""
        from dgraph_tpu_torch.storage.tabstats import (tablet_stats,
                                                 tablet_summary)
        # snapshot the map first: concurrent queries lazily fault
        # tablets in (and the budget evicts), so iterating the live
        # dict could die with "changed size during iteration"
        tablets: dict[str, dict] = {}
        for p, t in list(dict.items(self.tablets)):
            for _ in range(3):
                try:
                    tablets[p] = tablet_stats(t)
                    break
                except (RuntimeError, ValueError):
                    continue  # dict mutated mid-iteration; retry
            else:
                try:
                    st = tablet_summary(t)
                except (RuntimeError, ValueError):
                    st = {"predicate": p}
                st["partial"] = True
                tablets[p] = st
        return {
            "maxAssigned": self.coordinator.max_assigned(),
            "schemaEpoch": self.schema_epoch,
            "tablets": tablets,
            "cdc": self.cdc.stats(),
            "resultCache": self.result_cache.stats()
            if self.result_cache is not None else None,
            "cost": coststore.summary(),
            "costStore": coststore.stats(),
            "deviceCache": self.device_cache.stats(),
            "planCache": self.plan_cache.stats()
            if self.plan_cache is not None else None,
            "planner": self.planner_impl.stats()
            if self.planner_impl is not None else {"mode": "static"},
            "prefetch": self.prefetcher.stats()
            if self.prefetcher is not None else None,
        }
