"""Compiled query plans: skeleton canonicalization + LRU'd executables.

The executor interprets a parsed GQL query in host Python: every
request re-parses its text, re-walks the AST to schedule blocks,
re-derives per-stage constants (index tokens, compiled regexes, tier
choices) and — on the device tier — re-launches tensor ops per
stage. Under a high-concurrency request mix that per-request
interpreter overhead dominates small-query latency.

This module is the planner seam that removes both:

- `skeleton()` canonicalizes a ParsedResult into a structure hash with
  literals hoisted to parameters, so `eq(name, "alice")` and
  `eq(name, "bob")` share ONE plan.
- `PlanCache` holds an LRU of compiled `Plan`s keyed by
  `(skeleton, schema epoch, mesh layout)` plus a parse-LRU keyed by
  `(query text, variables)` — a warm request binds parameters and
  dispatches without re-parsing or re-deriving stage constants.
  Schema `alter` bumps the engine's epoch, making every stale plan
  unreachable (it ages out of the LRU).
- `Plan.memo()` caches parameter-derived stage artifacts (index token
  batches, compiled regex programs) keyed by the parameter VALUES, so
  the cache never serves one request's literals to another.
- `jit_stage()` is the process-global registry of stage executables,
  keyed by each stage's static shape and bounded by an LRU. In the
  reference every entry is one compiled `jax.jit`; in this port an
  entry is the plain callable over tensors that `build()` returns, and
  nothing is compiled. The registry keeps the reference's keys and
  bound, so `jit_stage_stats()` counts the same executables: a
  parameter-only change adds none. Device inputs are padded to
  power-of-two shape buckets (`ops/uidvec.pad_to`).

MVCC semantics are untouched: a plan caches structure- and
schema-derived state only, never data. Dirty tablets and overlay
reads fall back to the existing exact paths stage by stage, exactly
as the interpreted executor does.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

from dgraph_tpu_torch.gql.ast import (
    FilterTree, Function, GraphQuery, MathTree, ParsedResult,
)
from dgraph_tpu_torch.utils import metrics
from dgraph_tpu_torch.utils.tracing import span as _span

# literal placeholder in skeleton structure tuples; the hoisted value
# lands in the params list at the matching walk position
_P = "?"


# ----------------------------------------------------------------------
# skeleton canonicalization
# ----------------------------------------------------------------------


def _fn_skel(fn: Optional[Function], params: list) -> tuple:
    if fn is None:
        return ("fn", None)
    args = []
    for a in fn.args:
        params.append(a.value)
        args.append((_P, bool(a.is_value_var), bool(a.is_graphql_var)))
    params.append(tuple(fn.uids))
    return ("fn", fn.name, fn.attr, fn.lang, tuple(args),
            _P if fn.uids else (),
            tuple((vc.name, vc.typ) for vc in fn.needs_var),
            fn.is_count, fn.is_value_var, fn.is_len_var)


def _ft_skel(ft: Optional[FilterTree], params: list) -> tuple:
    if ft is None:
        return ("ft", None)
    return ("ft", ft.op, _fn_skel(ft.func, params),
            tuple(_ft_skel(c, params) for c in ft.children))


def _math_skel(mt: Optional[MathTree], params: list) -> tuple:
    if mt is None:
        return ("math", None)
    if mt.const is not None:
        params.append(mt.const)
    return ("math", mt.fn, _P if mt.const is not None else None, mt.var,
            tuple(_math_skel(c, params) for c in mt.children))


def _gq_skel(gq: GraphQuery, params: list) -> tuple:
    # names, aliases, flags and child shape are STRUCTURE (they decide
    # stage selection and the emitted JSON's keys); literal values —
    # uid lists, pagination numbers, function args, the checkpwd
    # plaintext — are parameters
    params.append(tuple(gq.uids))
    params.append((gq.first, gq.offset, gq.after))
    shortest = None
    if gq.shortest is not None:
        params.append((gq.shortest.numpaths, gq.shortest.depth,
                       gq.shortest.minweight, gq.shortest.maxweight))
        shortest = (_fn_skel(gq.shortest.from_, params),
                    _fn_skel(gq.shortest.to, params), _P)
    if gq.checkpwd_pwd is not None:
        params.append(gq.checkpwd_pwd)
    return (
        "gq", gq.attr, gq.alias, tuple(gq.langs),
        _P if gq.uids else (),
        _fn_skel(gq.func, params),
        _ft_skel(gq.filter, params),
        tuple((o.attr, o.desc, o.lang) for o in gq.order),
        (_P, gq.first is None),
        tuple(_gq_skel(c, params) for c in gq.children),
        gq.is_count, gq.is_internal, gq.var,
        tuple((vc.name, vc.typ) for vc in gq.needs_var),
        gq.expand,
        (gq.recurse.depth, gq.recurse.allow_loop)
        if gq.recurse is not None else None,
        shortest,
        gq.cascade, gq.normalize, gq.ignore_reflex,
        tuple((g.attr, g.alias, g.lang) for g in gq.groupby),
        gq.is_groupby,
        _math_skel(gq.math, params),
        gq.agg_func, gq.agg_pred,
        (gq.facets.all_keys, tuple(gq.facets.keys))
        if gq.facets is not None else None,
        _ft_skel(gq.facets_filter, params),
        tuple(sorted(gq.facet_var.items())),
        gq.checkpwd_pwd is not None,
        gq.is_empty,
    )


def skeleton(parsed: ParsedResult) -> tuple[tuple, tuple]:
    """Canonicalize a parsed query into (structure, params): the
    structure tuple is hashable and identical for any two queries that
    differ only in literal values; params is the hoisted literal
    vector in deterministic walk order."""
    params: list = []
    struct = ("q",
              tuple(_gq_skel(gq, params) for gq in parsed.queries),
              tuple(parsed.query_vars),
              tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                           for k, v in
                           (parsed.schema_request or {}).items()))
              if parsed.schema_request is not None else None)
    return struct, tuple(params)


# ----------------------------------------------------------------------
# plan IR
# ----------------------------------------------------------------------


_STAGE_NAMES = (
    ("recurse", lambda gq: gq.recurse is not None),
    ("shortest", lambda gq: gq.shortest is not None),
    ("groupby", lambda gq: gq.is_groupby),
)


def _block_stages(gq: GraphQuery) -> list[str]:
    """Human-readable stage chain for one block — the lowered IR
    `Plan.describe()` prints (tests assert on it; operators read it in
    debug output). Mirrors _run_block_inner's actual stage order."""
    stages = ["root:" + (gq.func.name if gq.func is not None
                         else ("uid" if gq.uids else "empty"))]
    for name, pred in _STAGE_NAMES:
        if pred(gq):
            stages.append(name)
    if gq.filter is not None:
        stages.append("filter")
    if gq.order:
        stages.append("sort:" + ",".join(o.attr for o in gq.order))
    if gq.first is not None or gq.offset or gq.after:
        stages.append("paginate")
    if gq.children:
        stages.append(f"expand[{len(gq.children)}]")
    if gq.cascade:
        stages.append("cascade")
    stages.append("emit")
    return stages


class Plan:
    """One compiled skeleton: the lowered stage IR plus every cached
    executable and parameter-memoized stage artifact that requests
    sharing this skeleton reuse. Immutable after compile except for
    the bounded memo/jit dicts (value-keyed, write-once entries)."""

    __slots__ = ("skeleton_hash", "skeleton_hex", "structure",
                 "stages", "epoch", "mesh_key", "_memo", "_memo_lock",
                 "compiled_ns", "_decisions", "_routing")

    MEMO_MAX = 256  # per-plan bound on param-derived artifacts

    def __init__(self, structure: tuple, skeleton_hash: int,
                 epoch: int, mesh_key: Any):
        self.skeleton_hash = skeleton_hash
        # pre-formatted: the planner/coststore join key, read per
        # stage consult on the query hot path
        self.skeleton_hex = f"{skeleton_hash:016x}"
        self.structure = structure
        self.epoch = epoch
        self.mesh_key = mesh_key
        self.stages: list[list[str]] = []
        # dglint: guarded-by=_memo:atomic,_decisions:atomic
        # (the hot read is a bare GIL-atomic dict probe by design;
        # writes are idempotent and serialize under _memo_lock)
        self._memo: dict = {}
        self._memo_lock = threading.Lock()
        self.compiled_ns = 0
        # planner tier decisions (query/planner.py), keyed per stage
        # with a re-optimization generation: kept APART from _memo so
        # param-churn memo clears never wipe tier choices, and so
        # EXPLAIN / /debug can enumerate the plan's current routing
        self._decisions: dict = {}
        # the executor's warm-request routing layer: its stage memo
        # key -> the live Decision, validated per request against the
        # planner's re-optimization generation with one dict probe —
        # so a warm request skips the estimate build AND the consult
        # (the adaptive planner's whole steady-state cost)
        self._routing: dict = {}

    def memo(self, key: tuple, build: Callable[[], Any]) -> Any:
        """Parameter-derived stage artifact cache (index token batches,
        compiled regexes). `key` MUST include every parameter value the
        artifact depends on — the plan is shared across requests whose
        literals differ. Unhashable keys fall through to build()."""
        try:
            got = self._memo.get(key, _MISS)
        except TypeError:
            return build()
        if got is not _MISS:
            return got
        val = build()
        with self._memo_lock:
            if len(self._memo) >= self.MEMO_MAX:
                self._memo.clear()  # rare: param-churn heavy skeleton
            self._memo.setdefault(key, val)
        return val

    def decide(self, key: tuple, version: int,
               build: Callable[[], Any]) -> Any:
        """Planner decision cache (same discipline as memo: bounded,
        write-racy-but-idempotent): ONE current decision per stage
        key. `version` is the planner's re-optimization generation —
        a bumped version makes the cached decision stale, so the next
        request rebuilds against fresh evidence; everything in
        between is served from the plan, which is what makes the
        adaptive planner's steady-state cost one dict probe."""
        got = self._decisions.get(key)
        if got is not None and got[0] == version:
            return got[1]
        val = build()
        with self._memo_lock:
            if len(self._decisions) >= self.MEMO_MAX:
                self._decisions.clear()  # rare: stage-key churn
            self._decisions[key] = (version, val)
        return val

    def decisions_snapshot(self) -> list:
        """Current tier decisions (EXPLAIN / /debug surface)."""
        with self._memo_lock:
            vals = [v for _ver, v in self._decisions.values()]
        return [v.describe() for v in vals
                if hasattr(v, "describe")]

    def describe(self) -> dict:
        return {"skeleton": f"{self.skeleton_hash:016x}",
                "epoch": self.epoch,
                "mesh": str(self.mesh_key),
                "blocks": [" -> ".join(s) for s in self.stages],
                "compile_us": self.compiled_ns // 1000}


_MISS = object()


# ----------------------------------------------------------------------
# the stage executable registry
# ----------------------------------------------------------------------

_JIT_LOCK = threading.Lock()
_JIT_MAX = 512
_JIT: "OrderedDict[tuple, Any]" = OrderedDict()


def jit_stage(name: str, build: Callable[[], Callable],
              static: tuple = ()) -> Callable:
    """Return the process-wide stage executable for `(name, static)`,
    calling `build()` on first use. `build()` returns a plain callable
    over tensors; the registry holds at most _JIT_MAX of them, least
    recently used out first."""
    key = (name, static)
    with _JIT_LOCK:
        fn = _JIT.get(key)
        if fn is not None:
            _JIT.move_to_end(key)
            return fn
    fn = build()
    with _JIT_LOCK:
        got = _JIT.setdefault(key, fn)
        _JIT.move_to_end(key)
        while len(_JIT) > _JIT_MAX:
            _JIT.popitem(last=False)
    return got


def jit_stage_stats() -> dict:
    with _JIT_LOCK:
        return {"executables": len(_JIT)}


def shape_bucket(n: int) -> int:
    """Power-of-two shape bucket for a uid-vector/column length — the
    cache key component that keeps per-shape executables bounded.
    Delegates to the ops-plane convention (masked sentinel tails)."""
    from dgraph_tpu_torch.ops.uidvec import pad_to
    return pad_to(int(n))


# ----------------------------------------------------------------------
# the cache
# ----------------------------------------------------------------------


def _mesh_key(db) -> Any:
    """The plan key's mesh layout: None on an engine without a mesh,
    which is every engine of this port until multi-device lands."""
    mesh = getattr(db, "mesh", None)
    if mesh is None:
        return None
    return tuple(sorted(mesh.shape.items()))


def _var_key(variables: Optional[dict]) -> tuple:
    if not variables:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in variables.items()))


class PlanCache:
    """Parse LRU (query text + variables -> ParsedResult + skeleton)
    over a plan LRU ((skeleton, schema epoch, mesh) -> Plan). Both
    bounded; thread-safe; counters feed /debug perf profiles:

      plan_cache_hits / plan_cache_misses / plan_cache_evictions
    """

    def __init__(self, size: int = 128, parse_size: Optional[int] = None):
        self.size = max(1, int(size))
        self.parse_size = parse_size if parse_size is not None \
            else self.size * 4
        self._lock = threading.Lock()
        self._parse: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._plans: "OrderedDict[tuple, Plan]" = OrderedDict()

    # -- parse tier ----------------------------------------------------

    def parse(self, q: str, variables: Optional[dict]
              ) -> tuple[ParsedResult, tuple, int]:
        """Cached gql parse. Returns (parsed, structure, skeleton hash).
        The cached ParsedResult is SHARED across requests and threads:
        the executor treats the AST as read-only (plans and ExecNodes
        carry all runtime state)."""
        from dgraph_tpu_torch.gql import parse as gql_parse

        key = (q, _var_key(variables))
        with self._lock:
            got = self._parse.get(key)
            if got is not None:
                self._parse.move_to_end(key)
                return got
        parsed = gql_parse(q, variables)
        struct, _params = skeleton(parsed)
        entry = (parsed, struct, hash(struct) & 0xFFFFFFFFFFFFFFFF)
        with self._lock:
            self._parse.setdefault(key, entry)
            self._parse.move_to_end(key)
            while len(self._parse) > self.parse_size:
                self._parse.popitem(last=False)
        return entry

    # -- plan tier -----------------------------------------------------

    def lookup(self, db, q: str, variables: Optional[dict],
               info: Optional[dict] = None
               ) -> tuple[ParsedResult, Plan]:
        """The engine's per-request entry: cached parse, then the
        compiled plan for (skeleton, db.schema_epoch, mesh layout).
        `info`, when given, reports the cache outcome
        ({"hit": bool}) — EXPLAIN surfaces it per request."""
        parsed, struct, skel_hash = self.parse(q, variables)
        epoch = getattr(db, "schema_epoch", 0)
        key = (skel_hash, struct, epoch, _mesh_key(db))
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                metrics.inc_counter("plan_cache_hits")
                if info is not None:
                    info["hit"] = True
                return parsed, plan
        metrics.inc_counter("plan_cache_misses")
        if info is not None:
            info["hit"] = False
        plan = self._compile(parsed, struct, skel_hash, epoch, key[3])
        with self._lock:
            plan = self._plans.setdefault(key, plan)
            self._plans.move_to_end(key)
            while len(self._plans) > self.size:
                self._plans.popitem(last=False)
                metrics.inc_counter("plan_cache_evictions")
        return parsed, plan

    def _compile(self, parsed: ParsedResult, struct: tuple,
                 skel_hash: int, epoch: int, mesh_key: Any) -> Plan:
        import time as _time

        with _span("plan.compile", skeleton=f"{skel_hash:016x}",
                   blocks=len(parsed.queries)):
            t0 = _time.perf_counter_ns()
            plan = Plan(struct, skel_hash, epoch, mesh_key)
            plan.stages = [_block_stages(gq) for gq in parsed.queries]
            plan.compiled_ns = _time.perf_counter_ns() - t0
        return plan

    def invalidate(self):
        """Drop everything (tests / operator escape hatch). Routine
        schema changes do NOT call this — the epoch key already makes
        stale plans unreachable and the LRU ages them out."""
        with self._lock:
            self._parse.clear()
            self._plans.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"plans": len(self._plans),
                    "parses": len(self._parse),
                    "size": self.size}
