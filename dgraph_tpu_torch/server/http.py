"""HTTP API server — the Alpha's public surface.

Port of `dgraph_tpu/server/http.py`: a copy, its imports pointed at
this package; `AlphaServer` and `serve` take `device` for the engine
they build (None: the card).

Endpoint map mirrors the reference (dgraph/cmd/alpha/run.go:415-436):

    POST /query     GraphQL± query; body is DQL text or JSON
                    {"query": ..., "variables": {...}}
                    ?explain=true|plan|analyze attaches the compiled
                    plan tree (+ measured actuals for analyze) under
                    extensions.explain — same as the in-query
                    `@explain` directive
                    (ref dgraph/cmd/alpha/http.go:162 queryHandler)
    POST /mutate    RDF or JSON mutation; ?commitNow=true commits
                    immediately, otherwise the response's
                    extensions.txn.start_ts names the open txn
                    (ref http.go:298 mutationHandler)
    POST /commit    ?startTs=N finishes a txn; ?abort=true discards
                    (ref http.go:446 commitHandler)
    POST /alter     schema text, or JSON {"drop_all": true} /
                    {"drop_attr": "name"} (ref http.go:528 alterHandler)
    GET  /health    liveness probe (ref x/health.go)
    GET  /state     cluster/engine introspection (ref edgraph/server.go:602)
    GET  /admin/schema        current schema text
    POST /admin/schema        same as /alter with schema text
    GET  /debug/prometheus_metrics   metrics text format (x/metrics.go)
    GET  /debug/stats         the always-on statistics plane: full
                              per-predicate tablet statistics, the
                              observed-cost store, engine cache states
                              (tools/dgtop.py polls this)

Transactions over HTTP are keyed by startTs exactly like the reference's
stateless protocol: /mutate without commitNow returns start_ts, the
client replays it to /mutate (more writes) or /commit.

Concurrency: a ThreadingHTTPServer front end over a reader-writer
lock — queries (MVCC snapshot reads) share the read side, mutations /
commits / alters take the write side, so a slow analytical query no
longer serializes the whole server (the reference gets the same shape
from goroutines + per-list RWMutex, posting/list.go). A small `meta`
mutex guards the txn table and ACL cache; lock order is rw -> meta,
never the reverse. Rollup (folds MVCC overlays — a write) is kept OFF
the read path (db.rollup_in_read=False) and runs throttled from the
write path instead.
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse

from dgraph_tpu_torch.cdc.changelog import OffsetTruncated
from dgraph_tpu_torch.cluster.coordinator import TxnAborted
from dgraph_tpu_torch.engine.db import GraphDB, Mutation, Txn
from dgraph_tpu_torch.server.acl import AclError
from dgraph_tpu_torch.utils import metrics, reqlog, tracing
from dgraph_tpu_torch.utils.logger import log
from dgraph_tpu_torch.utils.reqctx import (
    Cancelled, DeadlineExceeded, Overloaded, RequestContext,
)

# startTs -> open server-side txn (the reference keeps this state in the
# client + oracle; our engine txns are server objects, so the server maps)
_MAX_OPEN_TXNS = 4096


class AlphaServer:
    """Engine + txn table behind the HTTP front end."""

    def __init__(self, db: Optional[GraphDB] = None,
                 txn_ttl_s: float = 300.0,
                 acl_secret: Optional[bytes] = None,
                 mutations_mode: str = "allow",
                 max_pending: int = 0,
                 batch_window_us: int = 0,
                 tenant_rate: float = 0.0,
                 tenant_burst: float = 0.0,
                 device=None):
        if mutations_mode not in ("allow", "disallow", "strict"):
            raise ValueError(
                "--mutations argument must be one of allow, disallow, "
                "or strict")
        # ref --mutations (alpha/run.go:502): disallow rejects every
        # mutation and alter; strict rejects mutations naming
        # predicates with no schema entry (worker/mutation.go:693)
        self.mutations_mode = mutations_mode
        # a caller's engine keeps its device; the one built here runs
        # on `device` (None: the card, raising without one)
        self.db = db or GraphDB(device=device)
        from dgraph_tpu_torch.utils.rwlock import RWLock
        self.rw = RWLock()
        self.meta = threading.RLock()
        # concurrent readers must not trigger rollup (it rewrites the
        # tablet base arrays); the write path folds instead
        self.db.rollup_in_read = False
        self._commits_since_rollup = 0
        # draining: reject writes, keep serving reads (ref x/health.go
        # drainingMode + /admin/draining handler, alpha/admin.go)
        self.draining = False
        # admission control (ref edgraph/server.go pending-query
        # throttle answering RESOURCE_EXHAUSTED): a bounded in-flight
        # gauge over every work-bearing endpoint. 0 = unbounded.
        # Excess load sheds with HTTP 429 (retryable) instead of
        # queuing unboundedly in the thread-per-request front end.
        self.max_pending = max_pending
        self._admission = threading.Lock()
        self._inflight = 0
        # per-tenant QoS layered UNDER max_pending (server/qos.py):
        # one hot tenant exhausts its own token bucket and degrades
        # to 429s while the shared in-flight budget stays available
        # to every other tenant. 0 = off.
        self.qos = None
        if tenant_rate > 0:
            from dgraph_tpu_torch.server.qos import TenantQos
            self.qos = TenantQos(rate=tenant_rate, burst=tenant_burst)
        # trace id -> live RequestContexts, for /admin/cancel. A LIST:
        # trace ids are client-chosen, so an impatient retry can put
        # two live requests under one id — cancel hits them all, and
        # each request removes only its own handle on exit
        self._live_ctx: dict[str, list[RequestContext]] = {}
        self.txns: dict[int, Txn] = {}
        self._touched: dict[int, float] = {}
        # startTs -> userid that opened the txn (ACL mode only): /commit
        # must not let one login commit/abort another login's txn
        self._txn_owner: dict[int, str] = {}
        self.txn_ttl_s = txn_ttl_s
        # monotonic: /health uptime is a DURATION — an NTP step must
        # not make it jump (same for the txn idle clocks below)
        self.started_at = time.monotonic()
        # server-side micro-batching (engine/batcher.py): concurrent
        # best-effort queries sharing a plan-cache key coalesce into
        # one dispatch under ONE read-lock hold. 0 = off.
        self.batcher = None
        if batch_window_us > 0:
            from dgraph_tpu_torch.engine.batcher import MicroBatcher
            self.batcher = MicroBatcher(
                self.db, window_us=batch_window_us,
                read_lock=lambda: self.rw.read)
        # ACL enforcement turns on when a secret is configured
        # (ref --acl_secret_file, dgraph/cmd/alpha/run.go flags)
        self.acl = None
        if acl_secret is not None:
            from dgraph_tpu_torch.server.acl import AclManager
            self.acl = AclManager(self.db, acl_secret)

    def handle_login(self, body: dict) -> dict:
        if self.acl is None:
            raise ValueError("ACL is not enabled on this server")
        with self.meta:
            return {"data": self.acl.login(
                userid=body.get("userid", ""),
                password=body.get("password", ""),
                refresh_token=body.get("refresh_token", ""))}

    def _evict_idle(self):
        """Abort txns idle past the TTL (ref --abort_older_than,
        worker/draft.go:1166 abortOldTransactions)."""
        now = time.monotonic()
        for ts, t in list(self._touched.items()):
            if now - t > self.txn_ttl_s:
                txn = self.txns.pop(ts, None)
                self._touched.pop(ts, None)
                self._txn_owner.pop(ts, None)
                if txn is not None:
                    self.db.discard(txn)

    def _check_txn_owner(self, start_ts: int, claims: dict | None):
        """ACL mode: only the login that opened a txn (or a guardian)
        may touch it by startTs — they are guessable sequential ints
        (advisor finding; ref access_ee.go). Caller holds the lock."""
        if self.acl is None or claims is None:
            return
        from dgraph_tpu_torch.server.acl import GUARDIANS, AclError
        owner = self._txn_owner.get(start_ts)
        if (owner is not None
                and claims.get("userid", "") != owner
                and GUARDIANS not in claims.get("groups", [])):
            raise AclError(
                f"txn at startTs={start_ts} belongs to another user")

    def _maybe_rollup(self, every: int = 16):
        """Throttled overlay fold, called from the write path (caller
        holds the write lock). Replaces lazy rollup-in-read, which is
        unsafe once queries run concurrently."""
        self._commits_since_rollup += 1
        if self._commits_since_rollup >= every:
            self._commits_since_rollup = 0
            self.db.rollup_all()

    @contextmanager
    def _admit(self, ctx: Optional[RequestContext] = None):
        """One admission slot for the duration of a request. Sheds
        with Overloaded (-> 429, retryable) when max_pending slots are
        taken; a request that dies mid-flight (deadline, cancellation,
        any error) releases its slot in the finally. An already-dead
        context is rejected before it takes a slot.

        Tenant QoS runs before the shared gate: a tenant over its own
        rate sheds on its bucket without consuming an in-flight slot
        (untagged requests bill to "default"), so one hot tenant
        degrades to 429s while the rest keep their budget."""
        if ctx is not None:
            ctx.check("admission")
        if self.qos is not None:
            tenant = getattr(ctx, "tenant", "") or "default"
            if not self.qos.admit(tenant):
                metrics.inc_counter("dgraph_tenant_shed_total",
                                    labels={"tenant": tenant})
                raise Overloaded(
                    f"tenant {tenant!r} exceeded its admission rate; "
                    "retry with jittered backoff")
        with self._admission:
            if self.max_pending and self._inflight >= self.max_pending:
                metrics.inc_counter("dgraph_queries_shed_total")
                raise Overloaded(
                    f"server is overloaded: {self._inflight} requests "
                    f"in flight (max_pending={self.max_pending}); "
                    "retry with jittered backoff")
            self._inflight += 1
            metrics.set_gauge("dgraph_pending_queries", self._inflight)
            if ctx is not None:
                self._live_ctx.setdefault(ctx.trace_id, []).append(ctx)
        try:
            yield
        finally:
            with self._admission:
                self._inflight -= 1
                metrics.set_gauge("dgraph_pending_queries",
                                  self._inflight)
                if ctx is not None:
                    live = self._live_ctx.get(ctx.trace_id)
                    if live is not None:
                        if ctx in live:
                            live.remove(ctx)
                        if not live:
                            del self._live_ctx[ctx.trace_id]

    @contextmanager
    def _logged(self, op: str, ctx: Optional[RequestContext]):
        """Feed the /debug/requests ring: the ENGINE records
        successful query/mutate completions (it owns the per-phase
        breakdown), so this edge wrapper records successes only for
        ops the engine never sees (commit/alter) — and EVERY failure,
        with its outcome: a shed request (429) dies right here in
        admission and would otherwise be invisible."""
        t0 = time.perf_counter()
        tid = ctx.trace_id if ctx is not None else ""
        tenant = getattr(ctx, "tenant", "")
        try:
            yield
        except Exception as e:
            reqlog.record(op, trace_id=tid,
                          latency_ms=(time.perf_counter() - t0) * 1e3,
                          outcome=reqlog.outcome_of(e),
                          tenant=tenant)
            raise
        else:
            if op in ("commit", "alter"):
                reqlog.record(
                    op, trace_id=tid,
                    latency_ms=(time.perf_counter() - t0) * 1e3,
                    tenant=tenant)

    def pending(self) -> int:
        with self._admission:
            return self._inflight

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        """Graceful-drain helper: True once every admitted request has
        finished. Callers enable draining mode first so no new writes
        arrive, then wait here before shutting the engine down."""
        deadline = time.monotonic() + timeout_s
        while True:
            if self.pending() == 0:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def handle_cancel(self, params: dict, token: str = "") -> dict:
        """Cancel an in-flight request by trace id (guardians only
        under ACL). The cooperative flag fires at the executor's next
        block/level boundary and the request dies with 499, freeing
        its admission slot."""
        self._require_guardian(token, "/admin/cancel")
        tid = params.get("traceId", "")
        with self._admission:
            ctxs = list(self._live_ctx.get(tid, ()))
        if not ctxs:
            raise KeyError(f"no in-flight request with traceId={tid!r}")
        for ctx in ctxs:
            ctx.cancel()
        return {"code": "Success",
                "message": f"cancelled {len(ctxs)} request(s) "
                           f"with traceId {tid}"}

    # -- request handlers (transport-independent) --

    def _query_prologue(self, body: dict | str, params: dict,
                        token: str):
        """Shared /query front matter: body shapes, ACL authorization,
        read-only txn attachment."""
        if isinstance(body, dict):
            q = body.get("query", "")
            variables = body.get("variables")
        else:
            q, variables = body, None
        claims = None
        if self.acl is not None:
            from dgraph_tpu_torch.gql import parse as gql_parse
            from dgraph_tpu_torch.server.acl import query_predicates
            with self.meta:
                claims = self.acl.authorize(token)
                self.acl.authorize_query(
                    token, query_predicates(gql_parse(q, variables)),
                    claims=claims)
        ro_txn = None
        pin_ts = None
        start_ts = int(params.get("startTs", 0))
        with self.meta:
            if start_ts:
                self._check_txn_owner(start_ts, claims)
                ro_txn = self.txns.get(start_ts)
                if ro_txn is None:
                    # read-only snapshot at an explicit ts: no open txn
                    # exists for pure reads, so pin the MVCC read
                    # point directly — startTs=T must mean "read at T"
                    # (ref edgraph/server.go attaching ReadTs), not
                    # "allocate something newer"
                    pin_ts = start_ts
        be = params.get("be", "false") == "true"
        return q, variables, ro_txn, \
            (be if ro_txn is None else False), pin_ts

    @staticmethod
    def _explain_param(params: dict) -> Optional[str]:
        """`?explain=true|plan` -> "plan", `?explain=analyze` ->
        "analyze", absent/false -> None (the in-query `@explain`
        directive still applies either way)."""
        raw = str(params.get("explain", "")).lower()
        if raw in ("", "false", "0"):
            return None
        if raw in ("true", "plan"):
            return "plan"
        if raw == "analyze":
            return "analyze"
        raise ValueError(
            f"explain must be true/plan/analyze, got {raw!r}")

    def handle_query(self, body: dict | str, params: dict,
                     token: str = "", ctx=None) -> dict:
        with self._logged("query", ctx), self._admit(ctx):
            q, variables, ro_txn, be, pin_ts = self._query_prologue(
                body, params, token)
            with self.rw.read:
                return self.db.query(q, variables, txn=ro_txn,
                                     best_effort=be, read_ts=pin_ts,
                                     ctx=ctx,
                                     explain=self._explain_param(params))

    def handle_query_json(self, body: dict | str, params: dict,
                          token: str = "", ctx=None) -> str:
        """handle_query returning the serialized response body — flat
        blocks take the native columnar emitter (db.query_json), so
        the HTTP layer never re-serializes what the engine already
        encoded (ref query/outputnode.go fastJsonNode feeding the
        response writer directly)."""
        with self._logged("query", ctx), self._admit(ctx):
            q, variables, ro_txn, be, pin_ts = self._query_prologue(
                body, params, token)
            explain = self._explain_param(params)
            if self.batcher is not None and ro_txn is None \
                    and pin_ts is None and explain is None:
                # snapshot-unpinned, txn-free reads coalesce with
                # concurrent same-plan requests; the batcher takes the
                # read lock itself, once per batch, and serves every
                # member at one shared read_ts drawn from the SAME
                # source an unbatched dispatch would use now (strict:
                # one fresh coordinator ts; best-effort: the
                # watermark) — dispatch follows arrival, so each
                # member still observes every commit that completed
                # before it arrived
                return self.batcher.query_json(q, variables, ctx=ctx,
                                               best_effort=be)
            with self.rw.read:
                return self.db.query_json(q, variables, txn=ro_txn,
                                          best_effort=be,
                                          read_ts=pin_ts, ctx=ctx,
                                          explain=explain)

    def handle_mutate(self, body: bytes, content_type: str,
                      params: dict, token: str = "", ctx=None) -> dict:
        if self.draining:
            raise RuntimeError(
                "the server is in draining mode; write operations are "
                "rejected")
        if self.mutations_mode == "disallow":
            raise ValueError("no mutations allowed")
        with self._logged("mutate", ctx), self._admit(ctx):
            return self._mutate_admitted(body, content_type, params,
                                         token, ctx)

    def _mutate_admitted(self, body: bytes, content_type: str,
                         params: dict, token: str, ctx) -> dict:
        commit_now = params.get("commitNow", "false") == "true"
        start_ts = int(params.get("startTs", 0))
        muts, query, variables = _parse_mutation_body(body, content_type)
        owner = None
        preds: set[str] = set()
        if self.acl is not None or self.mutations_mode == "strict":
            from dgraph_tpu_torch.server.acl import nquad_predicates
            for mut in muts:
                preds |= set(nquad_predicates(
                    mut.set_nquads, mut.del_nquads,
                    mut.set_json, mut.delete_json))
        if self.acl is not None:
            from dgraph_tpu_torch.gql import parse as gql_parse
            from dgraph_tpu_torch.server.acl import query_predicates
            with self.meta:
                claims = self.acl.authorize(token)
                owner = claims.get("userid", "")
                self.acl.authorize_mutation(token, preds, claims=claims)
                if query:
                    self.acl.authorize_query(
                        token,
                        query_predicates(gql_parse(query, variables)),
                        claims=claims)
                if start_ts:
                    # attaching to an existing txn by startTs needs the
                    # same ownership check as /commit — startTs values
                    # are guessable sequential ints
                    self._check_txn_owner(start_ts, claims)
        with self.rw.write:
            if self.mutations_mode == "strict":
                # AFTER authorization (an unauthenticated client must
                # not probe which predicates exist) and UNDER the
                # write lock (a concurrent drop_attr/drop_all must not
                # race this check; ref worker/mutation.go:693 checks
                # in the worker, post-auth)
                for pred in sorted(preds):
                    if not self.db.schema.has(pred.lstrip("~")):
                        raise ValueError(
                            "Schema not defined for predicate: "
                            f"{pred.lstrip('~')}.")
            with self.meta:
                self._evict_idle()
                created = False
                if start_ts:
                    txn = self.txns.get(start_ts)
                    if txn is None:
                        # attach to a ts a previous /query handed out
                        txn = self.db.new_txn_at(start_ts)
                        created = True
                else:
                    txn = self.db.new_txn()
                    created = True
            try:
                out = self.db.mutate(txn, mutations=muts, query=query,
                                     variables=variables,
                                     commit_now=commit_now, ctx=ctx)
            except Exception:
                # a failed mutation aborts the whole txn (fail fast; the
                # reference marks the txn context aborted)
                with self.meta:
                    self.txns.pop(txn.start_ts, None)
                    self._touched.pop(txn.start_ts, None)
                    self._txn_owner.pop(txn.start_ts, None)
                self.db.discard(txn)
                raise
            ext_txn = {"start_ts": txn.start_ts}
            with self.meta:
                if commit_now:
                    self.txns.pop(txn.start_ts, None)
                    self._touched.pop(txn.start_ts, None)
                    self._txn_owner.pop(txn.start_ts, None)
                    if not txn.done:  # all conds failed: discard
                        self.db.discard(txn)
                else:
                    if created and len(self.txns) >= _MAX_OPEN_TXNS:
                        self.db.discard(txn)
                        raise RuntimeError("too many open transactions")
                    self.txns[txn.start_ts] = txn
                    self._touched[txn.start_ts] = time.monotonic()
                    if self.acl is not None and owner is not None:
                        self._txn_owner.setdefault(txn.start_ts, owner)
            if commit_now:
                self._maybe_rollup()
            out.setdefault("extensions", {})["txn"] = ext_txn
            return out

    def handle_commit(self, params: dict, token: str = "",
                      ctx=None) -> dict:
        start_ts = int(params.get("startTs", 0))
        abort = params.get("abort", "false") == "true"
        with self._logged("commit", ctx), self._admit(ctx), \
                self.rw.write:
            with self.meta:
                if self.acl is not None:
                    self._check_txn_owner(start_ts,
                                          self.acl.authorize(token))
                txn = self.txns.pop(start_ts, None)
                self._touched.pop(start_ts, None)
                self._txn_owner.pop(start_ts, None)
            if txn is None:
                raise KeyError(f"no open transaction at startTs={start_ts}")
            if abort:
                self.db.discard(txn)
                return {"code": "Success", "message": "Done",
                        "extensions": {"txn": {"start_ts": start_ts,
                                               "aborted": True}}}
            commit_ts = self.db.commit(txn)
            self._maybe_rollup()
            return {"code": "Success", "message": "Done",
                    "extensions": {"txn": {"start_ts": start_ts,
                                           "commit_ts": commit_ts}}}

    def handle_alter(self, body: bytes, token: str = "",
                     ctx=None) -> dict:
        if self.draining:
            raise RuntimeError(
                "the server is in draining mode; write operations are "
                "rejected")
        if self.mutations_mode == "disallow":
            # the reference gates Alter behind the same check
            # (edgraph/server.go:99 isMutationAllowed)
            raise ValueError("no mutations allowed")
        text = body.decode()
        drop_all = False
        drop_attr = ""
        schema = text
        try:
            j = json.loads(text)
            if isinstance(j, dict):
                drop_all = bool(j.get("drop_all"))
                drop_attr = j.get("drop_attr", "")
                schema = j.get("schema", "")
        except (json.JSONDecodeError, UnicodeDecodeError):
            pass
        if self.acl is not None:
            from dgraph_tpu_torch.server.acl import schema_predicates
            preds = [drop_attr] if drop_attr else (
                schema_predicates(schema) if schema else [])
            with self.meta:
                self.acl.authorize_alter(token, preds,
                                         drop=drop_all or bool(drop_attr))
        with self._logged("alter", ctx), self._admit(ctx), \
                self.rw.write:
            self.db.alter(schema_text=schema, drop_all=drop_all,
                          drop_attr=drop_attr, ctx=ctx)
        return {"code": "Success", "message": "Done"}

    def handle_state(self, token: str = "") -> dict:
        if self.acl is not None:
            with self.meta:
                self.acl.authorize(token)  # any valid login may inspect
        with self.rw.read:
            return self.db.state()

    def handle_traces(self, token: str = "",
                      params: Optional[dict] = None) -> dict:
        """Recent spans as a Chrome trace (load in chrome://tracing /
        Perfetto). `?trace_id=` narrows to one trace's node-local
        slice — collect the same id from every node and stitch with
        tools/trace_merge.py for the cluster-wide timeline.
        ACL-gated like /state: span args carry query shapes."""
        if self.acl is not None:
            with self.meta:
                self.acl.authorize(token)
        from dgraph_tpu_torch.utils.tracing import export_chrome_trace
        tid = (params or {}).get("trace_id") or None
        return {"traceEvents": export_chrome_trace(trace_id=tid)}

    def handle_subscribe(self, params: dict, token: str = "") -> dict:
        """GET /subscribe?pred=&offset=&waitMs=&limit=&id= — the CDC
        long-poll surface (cdc/changelog.py). Returns entries with
        offset > `offset` (at-least-once, resumable); an empty batch
        after waitMs is a heartbeat. A stale offset (below the log
        floor) raises OffsetTruncated — the HTTP edge maps it to 410
        with the re-sync coordinates. ACL: subscribing to a predicate
        is reading it. No admission slot: a long-poll parks a thread,
        not the engine — it must not starve query admission."""
        pred = params.get("pred", "")
        if not pred:
            raise ValueError("subscribe needs ?pred=")
        if self.acl is not None:
            with self.meta:
                self.acl.authorize_query(token, [pred])
        return self.db.cdc.read(
            pred,
            after=int(params.get("offset", 0)),
            limit=int(params.get("limit", 256)),
            wait_s=int(params.get("waitMs", 0)) / 1000.0,
            sub_id=str(params.get("id", "")))

    def handle_debug_stats(self, token: str = "") -> dict:
        """/debug/stats: the always-on statistics plane — every
        resident tablet's full statistics (storage/tabstats.py), the
        observed-cost summaries (utils/coststore.py), metrics
        histogram state, and the engine cache states. ACL-gated like
        /state: predicate names and fan-out shapes are data-shaped."""
        if self.acl is not None:
            with self.meta:
                self.acl.authorize(token)
        # no rw.read hold: a cold stats cache recomputes O(postings)
        # aggregates, and the rwlock's writer preference would park
        # every query arriving after one mutate behind the walk.
        # debug_stats retries/degrades on concurrent-mutation races.
        out = self.db.debug_stats()
        metrics.collect_process_gauges()
        out["histograms"] = metrics.histograms_snapshot()
        out["counters"] = metrics.counters_snapshot()
        out["gauges"] = metrics.gauges_snapshot()
        return out

    def handle_pprof(self, params: Optional[dict] = None,
                     token: str = "") -> dict:
        """/debug/pprof?seconds=N&hz=H&format=collapsed|speedscope|
        both — the on-demand wall-clock sampling profiler
        (utils/pprof.py). The request thread blocks for the sampling
        window (the Go pprof ?seconds= contract) and the response
        carries collapsed-stack text and/or speedscope JSON.
        ACL-gated like /state: stacks name code paths and predicates."""
        if self.acl is not None:
            with self.meta:
                self.acl.authorize(token)
        from dgraph_tpu_torch.utils import pprof, tracing
        return pprof.handle_params(params or {}, node=tracing.node())

    def handle_requests(self, token: str = "") -> dict:
        """/debug/requests: the bounded recent + slowest request log
        (trace_id, latency breakdown, shed/abort outcome). ACL-gated
        like /state."""
        if self.acl is not None:
            with self.meta:
                self.acl.authorize(token)
        return reqlog.snapshot()

    def handle_alerts(self, params: Optional[dict] = None,
                      token: str = "") -> dict:
        """/debug/alerts: the watchdog's rule catalog, firing set and
        recent transition events (utils/watchdog.py). `?ack=<series>`
        acknowledges a firing alert; `?silence=<series>&ttlS=<s>`
        suppresses new firings. ACL-gated like /state: rule series
        carry tenant and op names."""
        if self.acl is not None:
            with self.meta:
                self.acl.authorize(token)
        from dgraph_tpu_torch.utils import watchdog
        p = params or {}
        if p.get("ack"):
            return {"acked": watchdog.ack(p["ack"])}
        if p.get("silence"):
            watchdog.silence(p["silence"],
                             float(p.get("ttlS", 3600)))
            return {"silenced": True}
        return watchdog.alerts_payload()

    def handle_incidents(self, params: Optional[dict] = None,
                         token: str = "") -> dict:
        """/debug/incidents: the flight recorder's bundle ring —
        manifests by default, one full bundle with `?id=<bundle>`.
        ACL-gated like /state: bundles embed queries and stacks."""
        if self.acl is not None:
            with self.meta:
                self.acl.authorize(token)
        from dgraph_tpu_torch.utils import watchdog
        p = params or {}
        return watchdog.incidents_payload(
            limit=int(p.get("limit", 16)), bundle=p.get("id"))

    def handle_assign(self, params: dict, token: str = "") -> dict:
        """Lease a uid block (ref zero.go /assign?what=uids): clients
        like the live loader pre-allocate so blank nodes render as
        concrete uids and batches stay fully concurrent. Any valid
        login may lease (it is a write-path primitive)."""
        if self.acl is not None:
            with self.meta:
                self.acl.authorize(token)
        num = int(params.get("num", 1))
        if not 0 < num <= 1_000_000:
            raise ValueError("num must be in [1, 1000000]")
        first, last = self.db.coordinator.assign_uids(num)
        return {"startId": str(first), "endId": str(last)}

    def _require_guardian(self, token: str, what: str):
        if self.acl is not None:
            from dgraph_tpu_torch.server.acl import GUARDIANS
            with self.meta:
                claims = self.acl.authorize(token)
                if GUARDIANS not in claims.get("groups", []):
                    raise AclError(f"{what} needs guardian membership")

    def handle_export(self, params: dict, token: str = "") -> dict:
        """Server-side export to a directory on the ALPHA's filesystem
        (ref /admin { export(...) }, worker/export.go:376). Guardians
        only under ACL."""
        import os
        self._require_guardian(token, "/admin/export")
        fmt = params.get("format", "rdf")
        if fmt not in ("rdf", "json"):
            raise ValueError(f"format must be rdf or json, not {fmt!r}")
        dest = params.get("destination", "export")
        from dgraph_tpu_torch.ingest.export import (
            export_json, export_rdf, export_schema,
        )
        with self.rw.read:
            os.makedirs(dest, exist_ok=True)
            spath = os.path.join(dest, "g01.schema")
            with open(spath, "w") as f:
                f.write(export_schema(self.db))
            if fmt == "rdf":
                dpath = os.path.join(dest, "g01.rdf")
                with open(dpath, "w") as f:
                    for line in export_rdf(self.db):
                        f.write(line + "\n")
            else:
                dpath = os.path.join(dest, "g01.json")
                with open(dpath, "w") as f:
                    json.dump(export_json(self.db), f)
        return {"code": "Success",
                "message": "Export completed.",
                "files": [dpath, spath]}

    def handle_backup(self, params: dict, token: str = "") -> dict:
        """Server-side incremental backup (ref /admin { backup(...) },
        ee/backup). Guardians only under ACL; the manifest chain lives
        at the destination like the offline CLI's."""
        self._require_guardian(token, "/admin/backup")
        dest = params.get("destination", "")
        if not dest:
            raise ValueError("destination is required")
        force_full = params.get("forceFull", "false") == "true"
        from dgraph_tpu_torch.storage.backup import backup as do_backup
        with self.rw.write:
            # the rollup (a write) is quick; the expensive serialization
            # below runs under the READ lock so queries keep flowing.
            # window=0: the backup must capture EVERY commit
            self.db.rollup_all(window=0)
        with self.rw.read:
            entry = do_backup(self.db, dest, force_full=force_full)
        return {"code": "Success", "message": "Backup completed.",
                "entry": entry}

    def handle_health(self) -> dict:
        return {"status": "draining" if self.draining else "healthy",
                "uptime_s": round(time.monotonic() - self.started_at, 3),
                "openTxns": len(self.txns),
                "pendingQueries": self.pending(),
                "maxPending": self.max_pending}

    def handle_draining(self, enable: bool, token: str = "") -> dict:
        """Toggle draining (guardians only under ACL) — ref
        alpha/admin.go drainingHandler."""
        self._require_guardian(token, "/admin/draining")
        self.draining = enable
        log.info("draining", enable=enable)
        return {"code": "Success",
                "message": f"draining mode is now {enable}"}

    def handle_get_schema(self, token: str = "") -> dict:
        self._require_guardian(token, "/admin/schema")
        with self.rw.read:
            return {"schema": self.db.schema.describe_all()}


def _parse_mutation_body(body: bytes, content_type: str
                         ) -> tuple[list[Mutation], str, dict | None]:
    """Body formats (ref http.go:298 mutationHandler):
    application/rdf: raw N-Quads in {set {...} delete {...}} or plain
    sets; application/json: {"set": [...], "delete": [...],
    "query": "...", "cond": "..."} upsert envelope, or
    {"mutations": [ {...}, ... ], "query": "..."} with SEVERAL
    independently @if-gated mutations in one transaction (the
    reference's multi-mutation upsert request shape)."""
    if "json" in content_type:
        j = json.loads(body.decode())

        def one(m: dict) -> Mutation:
            mut = Mutation(cond=m.get("cond", ""))
            if "set" in m:
                mut.set_json = m["set"]
            if "delete" in m:
                mut.delete_json = m["delete"]
            if "setNquads" in m:
                mut.set_nquads = m["setNquads"]
            if "delNquads" in m:
                mut.del_nquads = m["delNquads"]
            return mut

        if "mutations" in j:
            muts = [one(m) for m in j["mutations"]]
        else:
            muts = [one(j)]
        return muts, j.get("query", ""), j.get("variables")
    text = body.decode()
    set_part, del_part, query, cond = _split_rdf_blocks(text)
    return [Mutation(set_nquads=set_part, del_nquads=del_part,
                     cond=cond)], query, None


def _split_rdf_blocks(text: str) -> tuple[str, str, str, str]:
    """Parse the RDF mutation envelope:
    `upsert { query {...} mutation [@if(...)] { set {...} delete {...} } }`
    or bare `{ set {...} delete {...} }` or raw triples."""
    s = text.strip()
    if not s.startswith(("upsert", "{")):
        return s, "", "", ""  # raw triples = set
    query = ""
    cond = ""
    body = s
    if s.startswith("upsert"):
        inner = _brace_body(s[len("upsert"):].lstrip())
        qpos = inner.find("query")
        mpos = inner.find("mutation")
        if qpos >= 0:
            qbody = _brace_body(inner[qpos + len("query"):].lstrip())
            query = "{" + qbody + "}"
        if mpos < 0:
            raise ValueError("upsert block without mutation")
        after = inner[mpos + len("mutation"):].lstrip()
        if after.startswith("@if"):
            depth = 0
            for i, ch in enumerate(after):
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                    if depth == 0:
                        cond = after[: i + 1]
                        after = after[i + 1:].lstrip()
                        break
        body = "{" + _brace_body(after) + "}"
    inner = _brace_body(body)
    parts = _scan_set_delete(inner)
    if parts is None:  # bare triples inside outer braces = set block
        return inner, "", query, cond
    return parts[0], parts[1], query, cond


def _scan_set_delete(inner: str) -> Optional[tuple[str, str]]:
    """Scan `set { ... } delete { ... }` sections; None if the content is
    bare triples instead."""
    set_part: list[str] = []
    del_part: list[str] = []
    i = 0
    n = len(inner)
    while True:
        while i < n and inner[i].isspace():
            i += 1
        if i >= n:
            break
        for kw, sink in (("set", set_part), ("delete", del_part)):
            if inner.startswith(kw, i) and \
                    inner[i + len(kw):].lstrip().startswith("{"):
                j = inner.index("{", i + len(kw))
                blk = _brace_body(inner[j:])
                sink.append(blk)
                i = j + len(blk) + 2
                break
        else:
            return None
    return "\n".join(set_part), "\n".join(del_part)


def _brace_body(s: str) -> str:
    """Content of the first balanced {...} (quote-aware)."""
    if not s.startswith("{"):
        raise ValueError(f"expected '{{' at {s[:20]!r}")
    depth = 0
    in_str = False
    esc = False
    for i, ch in enumerate(s):
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                return s[1:i]
    raise ValueError("unbalanced braces")


class _Handler(BaseHTTPRequestHandler):
    server_version = "dgraph-tpu/0.1"
    alpha: AlphaServer  # set by serve()

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, obj: Any):
        self._send_raw(code, json.dumps(obj).encode())

    def _send_raw(self, code: int, data: bytes):
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        ctx = getattr(self, "_trace_ctx", None)
        if ctx is not None:
            # traceparent OUT: the caller (or its collector) learns
            # which trace id to pull from /debug/traces on every node
            self.send_header("X-Dgraph-Trace-Id", ctx.trace_id)
            self.send_header("traceparent", tracing.format_traceparent(
                ctx.trace_id, ctx.parent_span))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, msg: str, code: int = 400, ecode: str = "Error",
               retryable: bool = False):
        ext: dict[str, Any] = {"code": ecode}
        if retryable:
            ext["retryable"] = True
        self._send(code, {"errors": [{"message": msg,
                                      "extensions": ext}]})

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n) if n else b""

    def _ctx(self) -> Optional[RequestContext]:
        """RequestContext from the request headers: the remaining
        budget in X-Dgraph-Deadline-Ms (the HTTP analogue of the gRPC
        timeout field), a W3C `traceparent` (trace id + the caller's
        span id — this request's spans, on every node it touches,
        join that trace), and/or a caller-chosen X-Dgraph-Trace-Id
        (echoed in errors; the /admin/cancel handle). No headers, no
        context — zero overhead for plain requests."""
        dl = self.headers.get("X-Dgraph-Deadline-Ms", "")
        tid = self.headers.get("X-Dgraph-Trace-Id", "")
        # QoS accounting namespace: the tenant rides the context into
        # admission (token buckets), reqlog and metrics
        tenant = self.headers.get("X-Dgraph-Tenant", "").strip()
        parent = ""
        got = tracing.parse_traceparent(
            self.headers.get("traceparent", ""))
        if got is not None:
            tid = tid or got[0]
            parent = got[1]
        if dl:
            try:
                return RequestContext.from_deadline_ms(
                    int(dl), trace_id=tid, parent_span=parent,
                    tenant=tenant)
            except ValueError:
                raise ValueError(
                    f"X-Dgraph-Deadline-Ms must be an integer ms "
                    f"budget, got {dl!r}") from None
        if tid or tenant:
            return RequestContext.background(trace_id=tid,
                                             parent_span=parent,
                                             tenant=tenant)
        return None

    def do_GET(self):
        u = urlparse(self.path)
        path = u.path
        params = {k: v[-1] for k, v in parse_qs(u.query).items()}
        token = self.headers.get("X-Dgraph-AccessToken", "")
        self._trace_ctx = None  # keep-alive: don't echo a stale trace
        try:
            if path == "/health":
                self._send(200, self.alpha.handle_health())
            elif path == "/subscribe":
                self._send(200, self.alpha.handle_subscribe(params,
                                                            token))
            elif path == "/state":
                self._send(200, self.alpha.handle_state(token))
            elif path == "/admin/schema":
                self._send(200,
                           {"data": self.alpha.handle_get_schema(token)})
            elif path == "/debug/traces":
                self._send(200, self.alpha.handle_traces(token, params))
            elif path == "/debug/requests":
                self._send(200, self.alpha.handle_requests(token))
            elif path == "/debug/stats":
                self._send(200, self.alpha.handle_debug_stats(token))
            elif path == "/debug/alerts":
                self._send(200, self.alpha.handle_alerts(params,
                                                         token))
            elif path == "/debug/incidents":
                self._send(200, self.alpha.handle_incidents(params,
                                                            token))
            elif path == "/debug/pprof":
                self._send(200, self.alpha.handle_pprof(params, token))
            elif path == "/debug/prometheus_metrics":
                from dgraph_tpu_torch.utils.metrics import render_prometheus

                text = render_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(text)))
                self.end_headers()
                self.wfile.write(text)
            else:
                self._error(f"no handler for GET {path}", 404)
        except AclError as e:
            self._error(str(e), 401)
        except OffsetTruncated as e:
            # 410 Gone carries the re-sync coordinates: snapshot-read
            # the predicate at resyncTs, resubscribe from
            # offset_for_ts(resyncTs) (docs/deployment.md runbook)
            self._send(410, {"errors": [{
                "message": str(e),
                "extensions": {"code": "OffsetTruncated",
                               "pred": e.pred, "floor": e.floor,
                               "resyncTs": e.resync_ts}}]})
        except DeadlineExceeded as e:
            # GET handlers take no RequestContext today, but the same
            # typed mapping as do_POST keeps cancellation from ever
            # collapsing into a 500 if one grows a deadline
            self._error(str(e), 408, ecode="DeadlineExceeded",
                        retryable=True)
        except Cancelled as e:
            self._error(str(e), 499, ecode="Cancelled")
        except (ValueError, KeyError) as e:
            # bad debug params (pprof format=, malformed seconds=)
            self._error(str(e), 400)
        except Exception as e:  # noqa: BLE001 — surface as API error
            log.error("http_internal_error", path=path, error=str(e),
                      trace=traceback.format_exc()[-800:])
            self._error(str(e), 500)

    def do_POST(self):
        u = urlparse(self.path)
        path = u.path
        params = {k: v[-1] for k, v in parse_qs(u.query).items()}
        ctype = self.headers.get("Content-Type", "")
        token = self.headers.get("X-Dgraph-AccessToken", "")
        # reset BEFORE _ctx() can raise: a malformed deadline header's
        # 400 must not echo a previous request's trace on a reused
        # connection
        self._trace_ctx = None
        try:
            ctx = self._ctx()
            self._trace_ctx = ctx
            body = self._body()
            if path == "/query":
                if "json" in ctype:
                    payload: Any = json.loads(body.decode())
                else:
                    payload = body.decode()
                debug = params.get("debug", "false") == "true" \
                    or self.headers.get("X-Dgraph-Debug", ""
                                        ).lower() not in ("", "false",
                                                          "0")
                if debug:
                    # per-request tier-routing profile: a metrics
                    # counter diff around the (dict-path) query shows
                    # where it routed — columnar hits, device ops,
                    # postings fallbacks, cache evictions. Counters
                    # are process-global, so concurrent traffic
                    # bleeds in; use on a quiet node or repeat.
                    before = metrics.counters_snapshot()
                    out = self.alpha.handle_query(payload, params,
                                                  token, ctx=ctx)
                    out.setdefault("extensions", {})["profile"] = {
                        "counters": metrics.counters_delta(before)}
                    self._send(200, out)
                else:
                    self._send_raw(200, self.alpha.handle_query_json(
                        payload, params, token, ctx=ctx).encode())
            elif path == "/mutate":
                self._send(200, self.alpha.handle_mutate(
                    body, ctype, params, token, ctx=ctx))
            elif path == "/commit":
                self._send(200, self.alpha.handle_commit(params, token,
                                                         ctx=ctx))
            elif path in ("/alter", "/admin/schema"):
                self._send(200, self.alpha.handle_alter(body, token,
                                                        ctx=ctx))
            elif path == "/admin/cancel":
                self._send(200, self.alpha.handle_cancel(params, token))
            elif path == "/assign":
                self._send(200, self.alpha.handle_assign(params, token))
            elif path == "/admin/export":
                self._send(200, self.alpha.handle_export(params, token))
            elif path == "/admin/backup":
                self._send(200, self.alpha.handle_backup(params, token))
            elif path == "/admin/draining":
                enable = params.get("enable", "true") == "true"
                self._send(200, self.alpha.handle_draining(enable, token))
            elif path == "/login":
                self._send(200, self.alpha.handle_login(
                    json.loads(body.decode()) if body else {}))
            else:
                self._error(f"no handler for POST {path}", 404)
        except TxnAborted as e:
            self._error(f"Transaction has been aborted. Please retry: {e}",
                        409)
        except Overloaded as e:
            self._error(str(e), 429, ecode="ResourceExhausted",
                        retryable=True)
        except DeadlineExceeded as e:
            self._error(str(e), 408, ecode="DeadlineExceeded",
                        retryable=True)
        except Cancelled as e:
            self._error(str(e), 499, ecode="Cancelled")
        except AclError as e:
            self._error(str(e), 401)
        except (ValueError, KeyError) as e:
            self._error(str(e), 400)
        except Exception as e:  # noqa: BLE001
            log.error("http_internal_error", path=path, error=str(e),
                      trace=traceback.format_exc()[-800:])
            self._error(str(e), 500)


def serve(db: Optional[GraphDB] = None, host: str = "127.0.0.1",
          port: int = 8080, block: bool = True,
          acl_secret: Optional[bytes] = None,
          tls_context=None, mutations_mode: str = "allow",
          max_pending: int = 0, batch_window_us: int = 0,
          tenant_rate: float = 0.0, tenant_burst: float = 0.0,
          device=None) -> tuple[ThreadingHTTPServer, AlphaServer]:
    """Start the Alpha HTTP server. With block=False, runs in a daemon
    thread and returns (httpd, alpha) for tests/embedding. Pass an
    ssl.SSLContext (server/tls.py server_context) to serve HTTPS/mTLS
    like the reference's --tls options (x/tls_helper.go).
    `max_pending` bounds concurrently admitted requests (0 = off);
    excess load sheds with 429. `batch_window_us` coalesces concurrent
    same-plan queries into one dispatch (0 = off). `tenant_rate`/
    `tenant_burst` enable per-tenant QoS token buckets keyed on the
    X-Dgraph-Tenant header (0 = off). Without `db` the engine is built
    on `device` (None: the card)."""
    alpha = AlphaServer(db, acl_secret=acl_secret,
                        mutations_mode=mutations_mode,
                        max_pending=max_pending,
                        batch_window_us=batch_window_us,
                        tenant_rate=tenant_rate,
                        tenant_burst=tenant_burst,
                        device=device)
    handler = type("BoundHandler", (_Handler,), {"alpha": alpha})
    httpd = ThreadingHTTPServer((host, port), handler)
    if tls_context is not None:
        # defer the handshake to the per-request handler thread: with
        # the default handshake-on-accept, one client that connects and
        # never sends a ClientHello would block the single accept loop
        # for everyone
        httpd.socket = tls_context.wrap_socket(
            httpd.socket, server_side=True,
            do_handshake_on_connect=False)
    if block:
        httpd.serve_forever()
    else:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
    return httpd, alpha
