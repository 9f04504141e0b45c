"""Tracing: hierarchical request spans + device profiler hooks.

The reference instruments requests with OpenCensus spans
(x/metrics.go + go.opencensus.io trace throughout edgraph/worker) and
exposes pprof profiles. Here:

- `span(name, **attrs)` records a wall-time span into a bounded
  in-process ring. Spans are HIERARCHICAL: each record carries
  `(trace_id, span_id, parent_id, node)`, and nesting is automatic —
  a contextvar tracks the active span, so a `span()` opened inside
  another becomes its child without callers threading ids.
- `bind(trace_id, parent_span_id)` joins the current context to an
  existing trace (the serving edges bind the RequestContext's ids so
  every span of a request — across threads and, via the wire fields,
  across nodes — shares one trace_id). An unbound span roots its own
  trace (trace_id = its span_id).
- W3C `traceparent` helpers (`format_traceparent`/`parse_traceparent`)
  carry the context over HTTP and gRPC metadata; the cluster wire
  carries raw `trace_id`/`parent_span` fields.
- `export_chrome_trace()` renders the ring in the Chrome trace-event
  format (load in chrome://tracing or Perfetto) with pid = node, so a
  multi-node merge (tools/trace_merge.py) shows one lane per node.
- `profile_device(dir)` wraps torch.profiler.profile: a Chrome trace
  of the host ops and, with a card, its kernels for everything run
  inside the block — the device analogue of the reference's pprof CPU
  profiles.

Spans are cheap (two clock reads + an 8-byte id + a deque append under
GIL; budget < 5 µs each, enforced by bench_micro.py --span-overhead
and tier-1) and on by default; the ring bounds memory. `set_enabled`
turns recording off entirely for benchmarking the overhead itself.

- `stage(name, **attrs)` is the hot-path form of a span, for the device
  layers (`ops/bitgraph`'s digest, `ops/knn.topk_device`). It is off by
  default, and off it returns one shared no-op context manager: a flag
  read, no clock, no id, no contextvar, no observer. `record_stages(True)`
  turns it on; each stage then appends a record to a list that grows
  until `take_stages()` takes it (not the span ring, which a window of
  calls would overflow). Both ends come from `time.time_ns()`, the
  clock `torch.profiler` stamps its events with, and a record carries
  its thread's `threading.get_ident()` (pthread_self, whose low 32 bits
  CUPTI stamps on the runtime calls a thread makes), so a device trace's
  kernels can be paired with the stage whose host interval launched
  them. Stages nest with spans: a stage's parent is the enclosing stage
  or span, and it joins the request's trace.

Span and stage names share `SPAN_NAMES`.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Iterator, Optional

_MAX_SPANS = 4096
_spans: deque = deque(maxlen=_MAX_SPANS)
_lock = threading.Lock()
_enabled = True

# span-close observers: the always-on stats plane (utils/coststore)
# subscribes here and aggregates per-stage durations without the
# tracing module knowing about it. Observers run OUTSIDE _lock, on the
# recording thread, with the finished span record; they MUST be cheap
# (the per-span budget includes them) and MUST NOT raise — a raising
# observer is dropped from the list rather than poisoning every span.
_observers: list = []


def add_span_observer(fn) -> None:
    """Register `fn(record)` to run at every span close. The record is
    the live ring entry — observers read, never mutate."""
    if fn not in _observers:
        _observers.append(fn)


def remove_span_observer(fn) -> None:
    try:
        _observers.remove(fn)
    except ValueError:
        pass

# Registry of every span name the tree emits. Span names are API the
# same way metric names are (trace queries and the Perfetto merge key
# on them), so dglint DG08 checks each literal span(...) name against
# this tuple — a typo'd name forks a trace nobody queries. Keep sorted.
SPAN_NAMES = (
    "batch.wait",
    "block",
    "commit",
    "device.tile_load",
    "digest",
    "digest.core",
    "digest.level1",
    "digest.seed",
    "encode",
    "eq",
    "execute",
    "expand",
    "ineq",
    "knn",
    "knn.epilogue",
    "knn.fetch",
    "knn.score",
    "knn.select",
    "knn.upload",
    "match",
    "mutate",
    "parse",
    "plan.compile",
    "query",
    "raft.apply",
    "rpc.recv",
    "rpc.send",
    "setops",
    "similar_to",
    "sort",
    "tablet.rollup",
    "vector.build",
    "wal.append",
)

# node identity: one process-global default (a deployed node is one
# process) plus a contextvar override for in-process multi-node
# harnesses, where each serving thread belongs to one logical node
_NODE = "local"
_NODE_CV: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "dgraph_tpu_trace_node", default=None)
# (trace_id, span_id) of the active span / bound request, or None
_CUR: contextvars.ContextVar[Optional[tuple[str, str]]] = \
    contextvars.ContextVar("dgraph_tpu_trace_ctx", default=None)


def set_enabled(on: bool) -> None:
    """Gate span RETENTION (the ring + /debug/traces). Registered span
    observers — notably the coststore's always-on aggregation — keep
    firing while disabled; silence those at their own switch (e.g.
    coststore.set_enabled)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def set_node(name: str) -> None:
    """Process-global node identity stamped on every span (pid lane in
    the merged Perfetto view). Cluster servers set e.g. alpha-g1-n2."""
    global _NODE
    _NODE = str(name)


def set_thread_node(name: str) -> None:
    """Node identity for THIS thread/context only — long-running
    serving threads of in-process multi-node harnesses call it once at
    thread start (no reset needed; the context dies with the thread)."""
    _NODE_CV.set(str(name))


def node() -> str:
    return _NODE_CV.get() or _NODE


# span ids: sequential from a random 64-bit per-process base — one
# C-level next() + a format beats os.urandom().hex() by ~1 µs/span,
# and the random base keeps ids distinct across the cluster's nodes
_ID_SEQ = itertools.count(int.from_bytes(os.urandom(8), "big"))


def new_span_id() -> str:
    return f"{next(_ID_SEQ) & 0xFFFFFFFFFFFFFFFF:016x}"


def current() -> Optional[tuple[str, str]]:
    """(trace_id, span_id) of the innermost active span or bound
    request context; None outside any trace."""
    return _CUR.get()


@contextlib.contextmanager
def bind(trace_id: str, parent_span_id: str = "",
         node: Optional[str] = None) -> Iterator[None]:
    """Join this context to an existing trace: spans opened inside
    become children of `parent_span_id` (the caller's span on the other
    side of the wire). `node` overrides the node identity for the
    block (in-process multi-node harnesses)."""
    tok = _CUR.set((str(trace_id), str(parent_span_id or "")))
    ntok = _NODE_CV.set(str(node)) if node is not None else None
    try:
        yield
    finally:
        _CUR.reset(tok)
        if ntok is not None:
            _NODE_CV.reset(ntok)


@contextlib.contextmanager
def bind_request(ctx) -> Iterator[None]:
    """Bind the trace of a RequestContext (None = no-op). Idempotent
    per trace: when the context is already bound to the same trace
    (e.g. the rpc.recv span of the serving loop), spans keep nesting
    under the CURRENT span instead of re-rooting at the wire parent."""
    if ctx is None:
        yield
        return
    cur = _CUR.get()
    if cur is not None and cur[0] == ctx.trace_id:
        yield
        return
    with bind(ctx.trace_id, getattr(ctx, "parent_span", "") or ""):
        yield


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[dict]:
    """Record one wall-time span; yields the attr dict so callers can
    attach results (e.g. result counts) before the span closes."""
    # observers (the coststore's always-on aggregation) outlive the
    # ring's enabled flag: set_enabled(False) stops RETAINING spans,
    # not MEASURING them. Sheds to a true no-op only when nobody is
    # listening at all.
    if not _enabled and not _observers:
        yield attrs
        return
    cur = _CUR.get()
    sid = new_span_id()
    if cur is None:
        trace_id, parent = sid, ""  # self-rooted trace
    else:
        trace_id, parent = cur
    # the start on the wall clock in ns, the clock torch.profiler's
    # events carry, so a ring span lines up with a device trace (and
    # chrome://tracing renders it as an absolute instant); the length on
    # the monotonic clock, which the cost store's buckets and maxima read.
    # `attrs` is the call's own fresh kwargs dict — no defensive copy
    rec = {"name": name, "trace_id": trace_id, "span_id": sid,
           "parent_id": parent, "node": _NODE_CV.get() or _NODE,
           "ts_us": time.time_ns() / 1e3,  # dglint: disable=DG06
           "tid": threading.get_ident(), "args": attrs}
    tok = _CUR.set((trace_id, sid))
    t0 = time.perf_counter_ns()
    try:
        yield rec["args"]
    finally:
        rec["dur_us"] = (time.perf_counter_ns() - t0) / 1e3
        _CUR.reset(tok)
        if _enabled:
            with _lock:
                _spans.append(rec)
        if _observers:
            for fn in list(_observers):
                try:
                    fn(rec)
                except Exception:
                    remove_span_observer(fn)


# ------------------------------------------------------------------ stages

_stages_on = False
_stage_recs: list = []


class _NoStage:
    """The one context manager `stage()` returns while recording is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_STAGE = _NoStage()


class _Stage:
    """One recorded stage: its record is appended when it closes."""

    __slots__ = ("rec", "tok")

    def __init__(self, name: str, attrs: dict):
        self.rec = {"name": name, "args": attrs}

    def __enter__(self) -> None:
        rec = self.rec
        cur = _CUR.get()
        sid = new_span_id()
        rec["trace_id"], rec["parent_id"] = (sid, "") if cur is None else cur
        rec["span_id"] = sid
        rec["tid"] = threading.get_ident()
        self.tok = _CUR.set((rec["trace_id"], sid))
        rec["t0_ns"] = time.time_ns()  # dglint: disable=DG06

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        rec["t1_ns"] = time.time_ns()  # dglint: disable=DG06
        _CUR.reset(self.tok)
        _stage_recs.append(rec)
        return False


def stage(name: str, **attrs: Any):
    """A stage of a device layer's call: a no-op unless `record_stages`
    is on, then a record of `name`, both ends on `time.time_ns()`, the
    thread, the enclosing stage or span as parent, the trace and
    `attrs`. Used as `with stage("knn.score"): ...`."""
    if not _stages_on:
        return _NO_STAGE
    return _Stage(name, attrs)


def record_stages(on: bool) -> None:
    """Turn stage recording on (dropping records not taken) or off
    (keeping them for `take_stages`)."""
    global _stages_on
    if on:
        del _stage_recs[:]
    _stages_on = bool(on)


def take_stages() -> list[dict]:
    """The stage records since recording was turned on, in the order
    they closed, removed from the list."""
    out = _stage_recs[:]
    # remove only what was copied: a stage closing meanwhile stays
    del _stage_recs[:len(out)]
    return out


def stage_events(stages: list[dict], base_ns: int = 0) -> list[dict]:
    """Stage records -> Chrome trace-event JSON: 'X' events in
    microseconds from `base_ns` on the profiler's clock."""
    return chrome_events([dict(r, ts_us=(r["t0_ns"] - base_ns) / 1e3,
                               dur_us=(r["t1_ns"] - r["t0_ns"]) / 1e3)
                          for r in stages])


# ------------------------------------------------------- W3C traceparent

_HEX = set("0123456789abcdef")


def _is_hex(s: str) -> bool:
    return bool(s) and all(c in _HEX for c in s)


def format_traceparent(trace_id: str, span_id: str = "") -> str:
    """`00-<32 hex trace>-<16 hex parent>-01`. Short hex ids (the
    16-hex RequestContext default) zero-pad; non-hex ids hash to a
    stable 32-hex form so the header is always well-formed."""
    t = str(trace_id).lower()
    if _is_hex(t) and len(t) <= 32:
        t = t.rjust(32, "0")
    else:
        import hashlib
        t = hashlib.blake2b(t.encode(), digest_size=16).hexdigest()
    s = str(span_id).lower()
    if not (_is_hex(s) and len(s) <= 16):
        s = new_span_id()
    return f"00-{t}-{s.rjust(16, '0')}-01"


def parse_traceparent(header: str) -> Optional[tuple[str, str]]:
    """-> (trace_id, parent_span_id), or None for a malformed header.
    The 32-hex trace id is kept VERBATIM as the request's trace_id so
    every node of the cluster reports the same id the caller sent."""
    parts = str(header or "").strip().lower().split("-")
    if len(parts) < 4:
        return None
    ver, tid, sid = parts[0], parts[1], parts[2]
    if len(ver) != 2 or len(tid) != 32 or len(sid) != 16:
        return None
    if not (_is_hex(ver) and _is_hex(tid) and _is_hex(sid)):
        return None
    if tid == "0" * 32 or sid == "0" * 16:
        return None
    return tid, sid


def current_traceparent() -> Optional[str]:
    cur = _CUR.get()
    if cur is None:
        return None
    return format_traceparent(cur[0], cur[1])


# ------------------------------------------------------------- ring reads


def recent_spans(limit: int = 200) -> list[dict]:
    with _lock:
        return list(_spans)[-limit:]


def spans_for(trace_id: str, limit: int = _MAX_SPANS) -> list[dict]:
    """The node-local slice of one trace (what /debug/traces?trace_id=
    and the cluster `traces` op return; tools/trace_merge.py stitches
    slices from several nodes into one timeline)."""
    with _lock:
        out = [s for s in _spans if s.get("trace_id") == trace_id]
    return out[-limit:]


def clear() -> None:
    with _lock:
        _spans.clear()


def node_pids(spans: list[dict]) -> dict[str, int]:
    """Node name -> Chrome trace pid lane (sorted node names,
    1-based). THE pid assignment for every event kind derived from a
    span set — chrome_events 'X' spans and trace_merge counter tracks
    must agree or counters land in the wrong process lane."""
    return {n: i + 1 for i, n in
            enumerate(sorted({s.get("node", "local") for s in spans}))}


def chrome_events(spans: list[dict]) -> list[dict]:
    """Span records -> Chrome trace-event JSON: one metadata
    process_name per node (pid = node lane) plus 'X' complete events
    carrying the span ids in args for parent-link inspection."""
    pid = node_pids(spans)
    nodes = sorted(pid)
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid[n], "tid": 0,
         "args": {"name": n}} for n in nodes]
    for s in spans:
        args = dict(s.get("args", ()))
        args["trace_id"] = s.get("trace_id", "")
        args["span_id"] = s.get("span_id", "")
        if s.get("parent_id"):
            args["parent_id"] = s["parent_id"]
        events.append({"name": s["name"], "ph": "X", "ts": s["ts_us"],
                       "dur": s.get("dur_us", 0.0),
                       "pid": pid[s.get("node", "local")],
                       "tid": s["tid"], "args": args})
    return events


def export_chrome_trace(trace_id: Optional[str] = None) -> list[dict]:
    """Chrome trace-event JSON ('X' complete events): load the result
    of /debug/traces straight into chrome://tracing / Perfetto. With
    trace_id, only that trace's node-local slice."""
    with _lock:
        spans = list(_spans)
    if trace_id is not None:
        spans = [s for s in spans if s.get("trace_id") == trace_id]
    return chrome_events(spans)


@contextlib.contextmanager
def profile_device(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace (host ops, and the card's kernels
    and copies where a card is present) of everything run inside the
    block, written as a Chrome trace to `log_dir`/trace.json: load it in
    chrome://tracing or Perfetto. Stages are recorded for the block and
    written beside it as `log_dir`/stages.json, counted from the same
    base (`baseTimeNanoseconds`) on the same clock."""
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    # inside an outer recording, leave its records and its switch alone
    was_on = _stages_on
    first = len(_stage_recs) if was_on else 0
    if not was_on:
        record_stages(True)
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        stages = _stage_recs[first:]
        if not was_on:
            record_stages(False)
            del _stage_recs[:]
    trace_path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(trace_path)
    # the profiler's trace counts from its own base; the stages share it
    with open(trace_path) as f:
        base = int(json.load(f).get("baseTimeNanoseconds", 0))
    with open(os.path.join(log_dir, "stages.json"), "w") as f:
        json.dump({"baseTimeNanoseconds": base,
                   "traceEvents": stage_events(stages, base)}, f)
