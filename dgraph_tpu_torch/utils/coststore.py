"""Observed-cost store: per-stage span durations -> streaming histograms.

The tracing plane (utils/tracing.py) records spans; this module is its
first always-on consumer, and the statistics source the cost-based tier
router (query/planner.py) reads instead of static thresholds like
`device_min_edges`. "Self-Driving Database Management Systems"
(PAPERS.md) is the template: keep cheap, always-on observations of
what each operator actually cost, keyed finely enough that a planner
can ask "what does an `eq` stage on this plan at this input size
usually take on this tier?".

Mechanics:

- a span observer (utils/tracing.add_span_observer) fires at every
  span close; stage spans (STAGES) aggregate into a bounded table
  keyed `(stage, tier, plan skeleton, size bucket)`:
    stage     the span name (eq/sort/expand/... plus the engine
              envelopes parse/execute/encode)
    tier      "host" unless the span carries a `tier` attr
              ("device" for device.tile_load)
    skeleton  the compiled plan's 16-hex skeleton hash — the engine
              binds it around execution (bind_plan), so every stage of
              a planned query lands under its plan; "" outside one
    bucket    power-of-two bucket of the span's row/edge count
- each key holds a log2 duration histogram (µs), count/sum, an EWMA
  summary, and the single slowest observation's (duration, trace_id) —
  the trace exemplar the Prometheus exporter attaches to its bucket.
- `save()`/`load()` persist the table as JSON; a store-backed GraphDB
  loads at boot and saves at checkpoint/close, so observations survive
  restarts (load MERGES, it never truncates live state). The table is
  process-global like the tracing plane it observes — spans carry no
  engine identity — so persistence assumes AT MOST ONE store-backed
  GraphDB per process at a time: two live engines with different
  store_dirs would fold each other's observations into both files.
- `render_prometheus()` emits the table aggregated per (stage, tier)
  as a `dgraph_stage_duration_us` histogram with an OpenMetrics-style
  trace exemplar on the bucket holding the slowest sample; it is
  registered with utils/metrics so /debug/prometheus_metrics carries
  it automatically.

The observer is ALWAYS ON once this module is imported (the engine
imports it). Budget: one frozenset probe for non-stage spans, a few
dict operations for stage spans — enforced by
`bench_micro.py --stats-overhead` (< 1% on the 21M-regime summary
queries) and the existing per-span budget in tests/test_tracing.py.

Port of `dgraph_tpu/utils/coststore.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time as _time
from bisect import bisect_left
from typing import Any, Iterator, Optional

from dgraph_tpu_torch.utils import metrics, tracing

# log2 duration buckets in µs: le 1, le 2, ..., le 2^19 (~0.5 s); one
# +Inf tail. Stage durations span ~1 µs (a memoized eq) to seconds (a
# cold 21M sort), so exponential buckets hold the whole range in 21
# counters per key.
N_BUCKETS = 20
BUCKETS_US = [float(1 << i) for i in range(N_BUCKETS)]
EWMA_ALPHA = 0.05
# fast companion EWMA: reacts in ~3 observations where the slow one
# takes ~20 — their RATIO is the drift signal the adaptive planner's
# re-optimization reads (a tier whose recent cost runs 2x its
# long-term average has drifted; see query/planner.py)
EWMA_FAST_ALPHA = 0.30
# below this many observations a cell's EWMAs are noise: estimate()
# reports the cell but flags it cold, and drift() stays neutral.
# 4 is deliberately low — each observation is a full stage execution,
# and the planner's margin rules (2x vs priors, 1.3x rival
# hysteresis) absorb the residual noise; a higher floor just delays
# adaptation by whole workload passes
MIN_WARM_COUNT = 4

# span names the observer aggregates — the executor's stage spans plus
# the engine/cluster envelopes. Everything else stays trace-only
# detail (names here must exist in tracing.SPAN_NAMES).
STAGES = frozenset((
    "batch.wait", "block", "commit", "device.tile_load", "encode",
    "eq", "execute", "expand", "ineq", "match", "mutate", "parse",
    "plan.compile", "query", "raft.apply", "rpc.recv", "rpc.send",
    "setops", "similar_to", "sort", "tablet.rollup", "wal.append",
))

# the active plan skeleton: the engine binds it around execution so
# stage spans key under their plan without threading an argument
# through every executor call
_PLAN_CV: contextvars.ContextVar[str] = contextvars.ContextVar(
    "dgraph_tpu_cost_plan", default="")


@contextlib.contextmanager
def bind_plan(skeleton: str) -> Iterator[None]:
    """Attribute stage spans closed inside the block to `skeleton`
    (the plan's 16-hex hash; "" for unplanned requests)."""
    tok = _PLAN_CV.set(str(skeleton))
    try:
        yield
    finally:
        _PLAN_CV.reset(tok)


def _size_bucket(args: dict) -> int:
    """Power-of-two size bucket from the span's own row/size attrs —
    bucket b covers counts in (2^(b-1), 2^b]; 0 = empty/unsized."""
    n = args.get("rows")
    if n is None:
        n = args.get("n")
    if n is None:
        n = args.get("edges")
    if type(n) is int:  # fast path: tracing sites emit plain ints
        return n.bit_length() if n > 0 else 0
    try:
        n = int(n)
    except (TypeError, ValueError):
        return 0
    return n.bit_length() if n > 0 else 0


class CostStore:
    """Bounded aggregation table. Entry value layout (list, mutated in
    place under the lock): [hist, count, sum_us, ewma_us, max_us,
    max_trace, last_mono, fast_ewma_us] where hist has N_BUCKETS+1
    slots (last = +Inf). `last_mono` is the monotonic stamp of the
    newest observation — /debug/stats reports each cell's age from it,
    so a cold/dead cell (a tier the planner stopped routing to, a
    skeleton that aged out) is distinguishable from a fresh one;
    `fast_ewma_us` is the quick-reacting EWMA whose ratio to the slow
    one is the drift signal."""

    MAX_KEYS = 4096

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._data: dict[tuple, list] = {}
        self._enabled = True
        # paths whose on-disk content is already folded into (or was
        # just written FROM) this store: load() skips them, so a
        # close-then-reopen cycle in one process cannot merge the same
        # observations twice
        self._synced_paths: set[str] = set()

    # -- recording -----------------------------------------------------

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    def enabled(self) -> bool:
        return self._enabled

    def record(self, stage: str, tier: str, skeleton: str,
               size_bucket: int, dur_us: float,
               trace_id: str = "") -> None:
        """Trusted-caller hot path (the span observer fires this for
        EVERY stage span): arguments arrive well-typed; the module
        level record() wrapper normalizes for external callers."""
        key = (stage, tier, skeleton, size_bucket)
        idx = bisect_left(BUCKETS_US, dur_us)
        now = _time.monotonic()
        with self._lock:
            e = self._data.get(key)
            if e is None:
                if len(self._data) >= self.MAX_KEYS:
                    # overflow: fold into the per-(stage, tier)
                    # aggregate key instead of growing unboundedly
                    # (skeleton churn is the only unbounded axis)
                    key = (key[0], key[1], "~", key[3])
                    e = self._data.get(key)
                if e is None:
                    e = [[0] * (N_BUCKETS + 1), 0, 0.0, dur_us, 0.0,
                         "", now, dur_us]
                    self._data[key] = e
            e[0][idx] += 1
            e[1] += 1
            e[2] += dur_us
            e[3] += EWMA_ALPHA * (dur_us - e[3])
            if dur_us >= e[4]:
                e[4] = dur_us
                e[5] = trace_id
            e[6] = now
            e[7] += EWMA_FAST_ALPHA * (dur_us - e[7])
    # (record stays under ~1 µs: one bisect over 20 floats + in-place
    # list updates under an uncontended lock)

    def observe_span(self, rec: dict) -> None:
        """The tracing observer: aggregate one finished span record.
        Runs on every stage span the process closes — bench_micro
        --stats-overhead holds the whole plane under 1% of the
        summary-query mix."""
        name = rec["name"]
        if name not in STAGES or not self._enabled:
            return
        args = rec["args"]
        tier = args.get("tier") or (
            "device" if name == "device.tile_load" else "host")
        self.record(name, str(tier), _PLAN_CV.get(), _size_bucket(args),
                    rec["dur_us"], rec.get("trace_id", ""))

    # -- reads ---------------------------------------------------------

    def summary(self, stage: Optional[str] = None,
                skeleton: Optional[str] = None) -> list[dict]:
        """Per-key summaries (optionally filtered), slowest-EWMA first
        — the `/debug/stats` "cost" payload and the per-plan query
        surface (`skeleton=` answers "what has THIS plan's stage mix
        been costing?")."""
        out = []
        now = _time.monotonic()
        with self._lock:
            items = list(self._data.items())
        for (st, tier, skel, bucket), e in items:
            if stage is not None and st != stage:
                continue
            if skeleton is not None and skel != skeleton:
                continue
            out.append({
                "stage": st, "tier": tier, "skeleton": skel,
                "size_bucket": bucket, "count": e[1],
                "sum_us": round(e[2], 3), "ewma_us": round(e[3], 3),
                "max_us": round(e[4], 3), "max_trace": e[5],
                # seconds since the newest observation landed in this
                # cell — the cold/dead-vs-fresh discriminator the
                # drift-invalidation signal needs (-1 = never stamped:
                # a pre-age persisted cell)
                "ageS": round(now - e[6], 3) if e[6] > 0 else -1,
                "fastEwmaUs": round(e[7], 3),
                "drift": round(e[7] / e[3], 3)
                if e[1] >= MIN_WARM_COUNT and e[3] > 0 else 1.0,
                "hist": list(e[0]),
            })
        out.sort(key=lambda r: -r["ewma_us"])
        return out

    def stats(self) -> dict:
        now = _time.monotonic()
        with self._lock:
            ages = [now - e[6] for e in self._data.values()
                    if e[6] > 0]
            return {"keys": len(self._data),
                    "observations": sum(e[1]
                                        for e in self._data.values()),
                    "freshestAgeS": round(min(ages), 3) if ages else -1,
                    "stalestAgeS": round(max(ages), 3) if ages else -1}

    # -- planner-facing estimate surface -------------------------------

    def estimate(self, stage: str, tier: str, size_bucket: int,
                 skeleton: str = "", exact_only: bool = False
                 ) -> Optional[dict]:
        """Observed-cost estimate for one (stage, tier) at an input
        size bucket — what the adaptive planner asks instead of
        trusting static priors. Fallback chain, most-specific first:

          exact     this plan's own (stage, tier, skeleton, bucket)
          overflow  the "~" aggregate the bounded table folds into
          scaled    the NEAREST populated bucket of the same
                    (stage, tier) under any skeleton, EWMA scaled
                    linearly in rows (2^Δbucket, clamped) — stage
                    costs are row-linear to first order

        Returns {ewma_us, fast_ewma_us, count, age_s, cell, warm} or
        None when the (stage, tier) has never been observed at all
        (the caller falls back to its documented static priors)."""
        now = _time.monotonic()

        def _p50(e: list) -> float:
            # histogram median, INTERPOLATED inside the bucket:
            # robust to the one-off spikes that poison a young EWMA —
            # a tier's FIRST observation is typically its cache build
            # (CSR export, pack materialization), and the slow EWMA
            # seeds on it, making the tier look expensive for ~20
            # observations. Interpolation matters: a raw
            # bucket-midpoint median moves in 2x steps, which no
            # reasonable rival-margin hysteresis can damp — two
            # near-equal tiers would flap on quantization noise. The
            # planner compares p50s; the EWMAs remain the drift
            # signal.
            half = e[1] / 2.0
            seen = 0
            for b, c in enumerate(e[0]):
                if not c:
                    continue
                if seen + c >= half:
                    if b >= N_BUCKETS:
                        return float(1 << N_BUCKETS)
                    lo = float(1 << (b - 1)) if b else 0.0
                    hi = float(1 << b)
                    return lo + (hi - lo) * (half - seen) / c
                seen += c
            return e[3]

        def _fmt(e: list, cell: str, scale: float = 1.0) -> dict:
            return {"ewma_us": e[3] * scale,
                    "fast_ewma_us": e[7] * scale,
                    "p50_us": _p50(e) * scale,
                    "count": e[1],
                    "age_s": (now - e[6]) if e[6] > 0 else -1.0,
                    "cell": cell,
                    "warm": e[1] >= MIN_WARM_COUNT}

        with self._lock:
            for skel, cell in ((skeleton, "exact"), ("~", "overflow")):
                e = self._data.get((stage, tier, skel, size_bucket))
                if e is not None and e[1]:
                    return _fmt(e, cell)
            if exact_only:
                # hot-path callers (the planner's per-outcome rival
                # check): two dict probes, NEVER the table scan below
                return None
            best = None  # (bucket distance, -count, bucket, entry)
            for (st, t, _sk, b), e in self._data.items():
                if st != stage or t != tier or not e[1]:
                    continue
                cand = (abs(b - size_bucket), -e[1], b, e)
                if best is None or cand[:2] < best[:2]:
                    best = cand
            if best is None:
                return None
            _d, _negc, b, e = best
            scale = min(64.0, max(1.0 / 64.0,
                                  2.0 ** (size_bucket - b)))
            return _fmt(e, "scaled", scale)

    def drift(self, stage: str, tier: str, size_bucket: int,
              skeleton: str = "") -> float:
        """fast-EWMA / slow-EWMA ratio of the most specific populated
        cell (1.0 = no drift / too cold to tell). > 1 means the tier
        got slower recently; < 1 faster — either way past the
        planner's threshold, a cached tier decision made against the
        old cost is stale."""
        with self._lock:
            for skel in (skeleton, "~"):
                e = self._data.get((stage, tier, skel, size_bucket))
                if e is not None and e[1] >= MIN_WARM_COUNT \
                        and e[3] > 0:
                    return e[7] / e[3]
        return 1.0

    def reset(self) -> None:
        with self._lock:
            self._data.clear()
            self._synced_paths.clear()

    # -- persistence ---------------------------------------------------

    def save(self, path: str) -> None:
        """Atomic JSON dump (tmp + rename): a crash mid-save must not
        leave a truncated store for the next boot's load()."""
        now = _time.monotonic()
        with self._lock:
            entries = [
                {"stage": k[0], "tier": k[1], "skeleton": k[2],
                 "bucket": k[3], "hist": list(e[0]), "count": e[1],
                 "sum_us": e[2], "ewma_us": e[3], "max_us": e[4],
                 "max_trace": e[5],
                 # age is persisted RELATIVE (monotonic clocks do not
                 # survive restarts); load() re-anchors it to the new
                 # process's clock
                 "age_s": round(now - e[6], 3) if e[6] > 0 else -1,
                 "fast_ewma_us": e[7]}
                for k, e in self._data.items()]
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"version": 2, "entries": entries}, f)
        os.replace(tmp, path)
        with self._lock:
            # the file is now a subset of the live table; loading it
            # back in this process would double every observation
            self._synced_paths.add(os.path.abspath(path))

    def load(self, path: str) -> int:
        """Merge a saved table into the live one (histograms/counts
        add; EWMA blends by observation count; max keeps the larger).
        Returns the number of entries merged; missing/corrupt files
        merge nothing. A path this store already saved to (or loaded
        from) in this process merges nothing either — a close-then-
        reopen cycle on the same store_dir must not fold the same
        observations in twice."""
        apath = os.path.abspath(path)
        with self._lock:
            if apath in self._synced_paths:
                return 0
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            entries = doc["entries"]
        except (OSError, ValueError, KeyError):
            return 0
        n = 0
        now = _time.monotonic()
        for ent in entries:
            try:
                key = (str(ent["stage"]), str(ent["tier"]),
                       str(ent["skeleton"]), int(ent["bucket"]))
                hist = [int(x) for x in ent["hist"]]
                if len(hist) != N_BUCKETS + 1:
                    continue
                cnt, s = int(ent["count"]), float(ent["sum_us"])
                ewma, mx = float(ent["ewma_us"]), float(ent["max_us"])
                trace = str(ent.get("max_trace", ""))
                # v1 files carry neither age nor the fast EWMA: an
                # unknown age re-anchors as "never stamped" (reported
                # -1 / maximally stale — exactly right for data of
                # unknown vintage), the fast EWMA seeds from the slow
                age = float(ent.get("age_s", -1))
                mono = (now - age) if age >= 0 else 0.0
                fast = float(ent.get("fast_ewma_us", ewma))
            except (KeyError, TypeError, ValueError):
                continue
            with self._lock:
                e = self._data.get(key)
                if e is None:
                    if len(self._data) >= self.MAX_KEYS:
                        continue
                    self._data[key] = [hist, cnt, s, ewma, mx, trace,
                                       mono, fast]
                else:
                    e[0] = [a + b for a, b in zip(e[0], hist)]
                    total = e[1] + cnt
                    if total:
                        e[3] = (e[3] * e[1] + ewma * cnt) / total
                        e[7] = (e[7] * e[1] + fast * cnt) / total
                    e[1] = total
                    e[2] += s
                    if mx > e[4]:
                        e[4], e[5] = mx, trace
                    e[6] = max(e[6], mono)
            n += 1
        with self._lock:
            self._synced_paths.add(apath)
        return n

    # -- Prometheus export ----------------------------------------------

    def render_prometheus(self) -> str:
        """`dgraph_stage_duration_us` histogram series aggregated per
        (stage, tier) — the skeleton/size axes stay in /debug/stats
        where cardinality is free — with an OpenMetrics-style trace
        exemplar (`# exemplar: {trace_id="..."} <µs>`) on its OWN
        comment line directly under the bucket holding the slowest
        observation, so a p99 cliff on a dashboard links straight to a
        pullable trace. The endpoint serves text format 0.0.4, whose
        grammar has no inline exemplar syntax — appending one to the
        sample line would abort a real Prometheus scrape of the WHOLE
        exposition; a line-leading comment is ignored by every 0.0.4
        parser and still adjacent for humans/dgtop. Empty store
        renders nothing."""
        agg: dict[tuple[str, str], list] = {}
        with self._lock:
            for (st, tier, _skel, _bucket), e in self._data.items():
                a = agg.get((st, tier))
                if a is None:
                    agg[(st, tier)] = [list(e[0]), e[1], e[2],
                                       e[4], e[5]]
                else:
                    a[0] = [x + y for x, y in zip(a[0], e[0])]
                    a[1] += e[1]
                    a[2] += e[2]
                    if e[4] > a[3]:
                        a[3], a[4] = e[4], e[5]
        if not agg:
            return ""
        name = "dgraph_stage_duration_us"
        lines = [f"# TYPE {name} histogram"]
        for (st, tier), (hist, count, sum_us, max_us, trace) in \
                sorted(agg.items()):
            lab = f'stage="{st}",tier="{tier}"'
            ex_idx = bisect_left(BUCKETS_US, max_us)
            cum = 0
            for i, b in enumerate(BUCKETS_US):
                cum += hist[i]
                lines.append(f'{name}_bucket{{{lab},le="{b:g}"}} {cum}')
                if trace and i == ex_idx:
                    lines.append(f'# exemplar: {{trace_id="{trace}"}} '
                                 f'{max_us:g}')
            cum += hist[-1]
            lines.append(f'{name}_bucket{{{lab},le="+Inf"}} {cum}')
            if trace and ex_idx >= N_BUCKETS:
                lines.append(f'# exemplar: {{trace_id="{trace}"}} '
                             f'{max_us:g}')
            lines.append(f'{name}_count{{{lab}}} {cum}')
            lines.append(f'{name}_sum{{{lab}}} {sum_us:g}')
        return "\n".join(lines) + "\n"


# ------------------------------------------------------- global store

_GLOBAL = CostStore()


def record(stage: str, tier: str = "host", skeleton: str = "",
           size_bucket: int = 0, dur_us: float = 0.0,
           trace_id: str = "") -> None:
    _GLOBAL.record(str(stage), str(tier) or "host", str(skeleton),
                   int(size_bucket), float(dur_us), str(trace_id))


def summary(stage: Optional[str] = None,
            skeleton: Optional[str] = None) -> list[dict]:
    return _GLOBAL.summary(stage=stage, skeleton=skeleton)


def stats() -> dict:
    return _GLOBAL.stats()


def estimate(stage: str, tier: str, size_bucket: int,
             skeleton: str = "",
             exact_only: bool = False) -> Optional[dict]:
    return _GLOBAL.estimate(stage, tier, size_bucket, skeleton,
                            exact_only)


def drift(stage: str, tier: str, size_bucket: int,
          skeleton: str = "") -> float:
    return _GLOBAL.drift(stage, tier, size_bucket, skeleton)


def reset() -> None:
    _GLOBAL.reset()


def set_enabled(on: bool) -> None:
    _GLOBAL.set_enabled(on)


def save(path: str) -> None:
    _GLOBAL.save(path)


def load(path: str) -> int:
    return _GLOBAL.load(path)


def render_prometheus() -> str:
    return _GLOBAL.render_prometheus()


def store() -> CostStore:
    return _GLOBAL


# always-on wiring: aggregate every stage span from import onward, and
# ride along /debug/prometheus_metrics
tracing.add_span_observer(_GLOBAL.observe_span)
metrics.register_renderer(_GLOBAL.render_prometheus)
