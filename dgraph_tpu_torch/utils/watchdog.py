"""Per-node watchdog: alert evaluation tick + incident flight recorder.

One daemon thread per process (tick ~1 s, DGRAPH_TPU_WATCHDOG_TICK_S)
drives utils/alerts.py's AlertManager over two inputs:

  - the request log's completion stream (SLO burn-rate windows; wired
    through reqlog.add_observer at start())
  - a signals dict assembled each tick: metric-derived signals
    computed HERE (WAL fsync p99, shed rate, result-cache hit
    fraction, tile-cache thrash, DR standby lag) plus whatever the
    hosting server registered via register_signals (raft apply lag,
    silent peers, CDC subscriber lag, stuck-move age).

On any rule's ok->firing transition the flight recorder captures an
incident bundle — the artifact set dgbench's evidence phase collects,
but triggered automatically at the moment of damage, BEFORE the
bounded rings evict it: metrics+gauges snapshot, the request ring
(slowest entries carry trace ids), the span ring's recent traces, a
2 s pprof profile, planner/plan-cache state (context providers), and
the active netfault rules. Bundles live in a bounded on-disk ring
(default 8, oldest evicted first) that survives process restarts (the
recorder re-scans its directory on boot).

Surfaces: /debug/alerts + /debug/incidents on both HTTP listeners,
{"op": "alerts"} / {"op": "incidents"} on the cluster wire,
dgraph_alerts_firing{rule} in Prometheus, the dgtop ALERTS panel, and
tools/dgalert.py. The module-level singleton keeps all of them
serving (empty-but-valid) even when no watchdog thread was started —
library embeddings and unit tests pay nothing.

Port of `dgraph_tpu/utils/watchdog.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Callable, Optional

from dgraph_tpu_torch.utils import alerts as alerts_mod
from dgraph_tpu_torch.utils import metrics

_BUNDLE_FILES = ("manifest.json", "metrics.json", "requests.json",
                 "traces.json", "pprof.json", "netfault.json",
                 "context.json")


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class IncidentRecorder:
    """Bounded on-disk ring of incident bundles.

    Each bundle is one directory `inc-<seq>-<rule>` under `root`;
    `max_bundles` newest are kept, oldest evicted first. The seq
    counter resumes past existing bundles on boot, so the ring (and
    its eviction order) survives process restarts."""

    def __init__(self, root: str, max_bundles: int = 8):
        self.root = root
        self.max_bundles = max(1, int(max_bundles))
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)
        self._seq = 1 + max(
            [self._seq_of(d) for d in self._scan()] or [0])

    def _scan(self) -> list[str]:
        try:
            return sorted(d for d in os.listdir(self.root)
                          if d.startswith("inc-"))
        except OSError:
            return []

    @staticmethod
    def _seq_of(dirname: str) -> int:
        try:
            return int(dirname.split("-")[1])
        except (IndexError, ValueError):
            return 0

    def list(self) -> list[dict]:
        """Manifests of every bundle on disk, oldest first."""
        out = []
        for d in sorted(self._scan(), key=self._seq_of):
            try:
                with open(os.path.join(self.root, d,
                                       "manifest.json")) as f:
                    m = json.load(f)
            except (OSError, ValueError):
                m = {}
            m["id"] = d
            out.append(m)
        return out

    def read(self, bundle_id: str) -> dict:
        """One bundle's full contents (JSON files inlined)."""
        base = os.path.join(self.root, os.path.basename(bundle_id))
        if not os.path.isdir(base):
            raise KeyError(f"no incident bundle {bundle_id!r}")
        out: dict = {"id": os.path.basename(bundle_id)}
        for fn in _BUNDLE_FILES:
            p = os.path.join(base, fn)
            if not os.path.exists(p):
                continue
            try:
                with open(p) as f:
                    out[fn.rsplit(".", 1)[0]] = json.load(f)
            except (OSError, ValueError) as e:
                out[fn.rsplit(".", 1)[0]] = {"unreadable": str(e)}
        return out

    def capture(self, event: dict, node: str,
                context_providers: dict[str, Callable[[], dict]],
                pprof_s: float = 2.0) -> str:
        """Write one bundle; returns its id. Runs on the capture
        thread — the pprof window blocks HERE, never the tick."""
        from dgraph_tpu_torch.utils import failpoint, netfault, pprof, \
            reqlog, tracing
        # chaos seam: delay/fail a capture mid-incident (a full disk
        # at the worst moment must not take the evaluator down)
        failpoint.fire("watchdog.capture")
        with self._lock:
            seq = self._seq
            self._seq += 1
        rule = "".join(c if c.isalnum() or c in "_." else "_"
                       for c in str(event.get("rule", "rule")))
        bid = f"inc-{seq:06d}-{rule}"
        tmp = os.path.join(self.root, "." + bid)
        os.makedirs(tmp, exist_ok=True)

        def _dump(fn: str, obj) -> None:
            with open(os.path.join(tmp, fn), "w") as f:
                json.dump(obj, f, default=str)

        metrics.collect_process_gauges()
        _dump("metrics.json",
              {"counters": metrics.counters_snapshot(),
               "gauges": metrics.gauges_snapshot(),
               "histograms": metrics.histograms_snapshot()})
        _dump("requests.json", reqlog.snapshot())
        spans = tracing.recent_spans(512)
        _dump("traces.json",
              {"spans": spans,
               "trace_ids": sorted({s.get("trace_id") for s in spans
                                    if s.get("trace_id")})})
        _dump("netfault.json", {"rules": netfault.rules()})
        ctx = {}
        for name, fn in context_providers.items():
            try:
                ctx[name] = fn()
            except Exception as e:  # noqa: BLE001 — a provider bug  # dglint: disable=DG07 (capture thread; no request context)
                ctx[name] = {"error": str(e)}  # can't lose the bundle
        _dump("context.json", ctx)
        try:
            prof = pprof.collect(seconds=pprof_s) \
                .to_payload("collapsed")
        except RuntimeError as e:
            # another collection in flight: record why, keep bundle
            prof = {"error": str(e)}
        _dump("pprof.json", prof)
        _dump("manifest.json", {
            "rule": event.get("rule"), "series": event.get("series"),
            "value": event.get("value"),
            "severity": event.get("severity"),
            "node": node, "seq": seq,
            "captured_at": event.get("ts"),
            "files": list(_BUNDLE_FILES)})
        final = os.path.join(self.root, bid)
        os.replace(tmp, final)  # readers never see a half bundle
        self._evict()
        return bid

    def _evict(self) -> None:
        with self._lock:
            dirs = sorted(self._scan(), key=self._seq_of)
            while len(dirs) > self.max_bundles:
                victim = dirs.pop(0)  # oldest-first
                shutil.rmtree(os.path.join(self.root, victim),
                              ignore_errors=True)


class Watchdog:
    """The per-process evaluator. Construct via ensure_started()."""

    # dglint: guarded-by=_signal_providers:atomic,_context_providers:atomic,node:write-once
    # (provider registries are copy-on-write: register_* rebinds a
    # fresh dict, readers snapshot the reference — never mutated in
    # place under an iterating tick/capture thread; node is set once
    # before the loop/capture threads exist)

    def __init__(self, tick_s: float = 1.0,
                 incident_dir: Optional[str] = None,
                 max_bundles: int = 8,
                 manager: Optional[alerts_mod.AlertManager] = None):
        self.tick_s = float(tick_s)
        self.manager = manager or _manager()
        self.recorder = IncidentRecorder(
            incident_dir, max_bundles) if incident_dir else None
        self.node = ""
        self._signal_providers: dict[str, Callable[[], dict]] = {}
        self._context_providers: dict[str, Callable[[], dict]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # None until the first tick: rates need a baseline — deltas
        # against an empty dict would read the process's LIFETIME
        # counters as one tick's worth and false-fire every rate rule
        self._prev_counters: Optional[dict[str, float]] = None
        self._prev_fsync: Optional[dict] = None
        self._prev_mono = time.monotonic()
        self._capture_cooldown_s = _env_f(
            "DGRAPH_TPU_INCIDENT_COOLDOWN_S", 60.0)
        self._pprof_s = _env_f("DGRAPH_TPU_INCIDENT_PPROF_S", 2.0)
        self._last_capture: dict[str, float] = {}  # series -> mono
        self._capturing = threading.Lock()

    # ---------------------------------------------------- registration

    def register_signals(self, name: str,
                         fn: Callable[[], dict]) -> None:
        """fn() -> partial signals dict, merged into each tick (the
        hosting AlphaServer/ZeroServer contributes raft/CDC/move
        signals this module must not compute itself)."""
        self._signal_providers = {**self._signal_providers,
                                  name: fn}

    def register_context(self, name: str,
                         fn: Callable[[], dict]) -> None:
        """fn() -> one section of the incident bundle's context.json
        (planner/plan-cache state, zero's move ledger, ...)."""
        self._context_providers = {**self._context_providers,
                                   name: fn}

    # ----------------------------------------------------------- tick

    def start(self, node: str = "") -> None:
        if self._thread is not None:
            return
        self.node = node or self.node
        from dgraph_tpu_torch.utils import reqlog
        reqlog.add_observer(self.manager.observe_request)
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"watchdog-{self.node or 'node'}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        from dgraph_tpu_torch.utils import reqlog
        reqlog.remove_observer(self.manager.observe_request)
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the watchdog must  # dglint: disable=DG07 (daemon loop; no request context flows here)
                pass  # outlive any one bad tick/provider

    def tick(self) -> list[dict]:
        """One evaluation: assemble signals, run the rules, export
        the firing gauge, trigger captures on ok->firing edges.
        Public for tests and the overhead gate."""
        signals = self.collect_signals()
        transitions = self.manager.evaluate(signals)
        metrics.inc_counter("dgraph_watchdog_ticks_total")
        # one gauge per RULE (not per series: label cardinality is
        # API) — count of firing series under that rule
        per_rule: dict[str, int] = {r.name: 0
                                    for r in self.manager.rules}
        for f in self.manager.firing():
            per_rule[f["rule"]] = per_rule.get(f["rule"], 0) + 1
        for rule, n in per_rule.items():
            metrics.set_gauge("dgraph_alerts_firing", n,
                              labels={"rule": rule})
        for ev in transitions:
            if ev["state"] == "firing":
                self._maybe_capture(ev)
        return transitions

    # -------------------------------------------------------- signals

    def collect_signals(self) -> dict:
        now = time.monotonic()
        dt = max(1e-3, now - self._prev_mono)
        self._prev_mono = now
        cur = metrics.counters_snapshot()
        prev, self._prev_counters = self._prev_counters, cur
        if prev is None:
            prev = cur  # baseline tick: every rate reads 0

        def rate(prefix: str) -> float:
            d = 0.0
            for k, v in cur.items():
                if k.startswith(prefix):
                    d += v - prev.get(k, 0.0)
            return max(0.0, d) / dt

        signals = {
            "sheds_per_s": rate("dgraph_queries_shed_total")
            + rate("dgraph_tenant_shed_total"),
            "tile_evictions_per_s": rate("device_cache_evictions"),
        }
        # result-cache hit fraction over the tick's lookups (hit
        # collapse needs volume context: an idle cache is not a
        # collapsed one)
        hits = rate("dgraph_result_cache_hits_total") * dt
        misses = rate("dgraph_result_cache_misses_total") * dt
        if hits + misses >= _env_f(
                "DGRAPH_TPU_ALERT_CACHE_MIN_LOOKUPS", 100.0):
            signals["result_cache_hit_frac"] = \
                hits / (hits + misses)
        # DR standby lag: max over the per-predicate gauge series
        lags = [v for k, v in metrics.gauges_snapshot().items()
                if k.startswith("dgraph_repl_lag_entries")]
        if lags:
            signals["dr_lag_entries"] = max(lags)
        # WAL fsync p99 from the histogram's tick delta
        p99 = self._fsync_p99()
        if p99 is not None:
            signals["wal_fsync_p99_s"] = p99
        for name, fn in self._signal_providers.items():
            try:
                got = fn()
            except Exception:  # noqa: BLE001 — a provider bug must  # dglint: disable=DG07 (watchdog tick; no request context)
                continue  # not kill the tick
            if got:
                signals.update(got)
        return signals

    def _fsync_p99(self) -> Optional[float]:
        snap = metrics.histograms_snapshot()
        # merge every dgraph_wal_fsync_seconds series (labels differ
        # per wal file) into one bucket vector
        merged: Optional[list[float]] = None
        edges: list[float] = []
        for k, h in snap.items():
            if not k.startswith("dgraph_wal_fsync_seconds"):
                continue
            edges = h["le"]
            if merged is None:
                merged = [0.0] * len(h["buckets"])
            for i, c in enumerate(h["buckets"]):
                merged[i] += c
        if merged is None:
            self._prev_fsync = None
            return None
        prev, self._prev_fsync = self._prev_fsync, \
            {"b": list(merged)}
        if prev is None or len(prev["b"]) != len(merged):
            return None  # baseline tick: lifetime counts are not a
            # tick window
        delta = [c - p for c, p in zip(merged, prev["b"])]
        total = sum(delta)
        if total < _env_f("DGRAPH_TPU_ALERT_FSYNC_MIN_OBS", 5.0):
            return None  # too few fsyncs this tick to judge a p99
        want = 0.99 * total
        cum = 0.0
        for i, c in enumerate(delta):
            cum += c
            if cum >= want:
                return edges[i] if i < len(edges) else edges[-1] * 2
        return edges[-1] * 2

    # -------------------------------------------------------- capture

    def _maybe_capture(self, event: dict) -> None:
        if self.recorder is None:
            return
        series = event.get("series", "")
        now = time.monotonic()
        last = self._last_capture.get(series)
        if last is not None \
                and now - last < self._capture_cooldown_s:
            return  # per-series cooldown: a flapping rule must not
            # churn the whole ring
        self._last_capture[series] = now
        threading.Thread(target=self._capture, args=(event,),
                         daemon=True,
                         name="watchdog-capture").start()

    def _capture(self, event: dict) -> None:
        with self._capturing:  # one bundle at a time (pprof is
            # process-wide anyway); a burst of transitions queues
            try:
                self.recorder.capture(
                    event, self.node, self._context_providers,
                    pprof_s=self._pprof_s)
                metrics.inc_counter("dgraph_incidents_total")
            except Exception:  # noqa: BLE001 — a full disk must not  # dglint: disable=DG07 (capture thread; no request context)
                pass  # take the watchdog down with it


# ------------------------------------------------------------ process
# One watchdog (and one AlertManager) per process: a deployed node is
# one process, and every surface (wire op, both HTTP listeners,
# Prometheus, dgtop, dgalert) reads the same state. The manager
# exists even when no thread was started, so surfaces stay valid
# (rule catalog + empty firing set) in library embeddings and tests.

_LOCK = threading.Lock()
_WATCHDOG: Optional[Watchdog] = None
_MANAGER: Optional[alerts_mod.AlertManager] = None


def _manager() -> alerts_mod.AlertManager:
    global _MANAGER
    with _LOCK:
        if _MANAGER is None:
            _MANAGER = alerts_mod.AlertManager()
        return _MANAGER


def get() -> Optional[Watchdog]:
    return _WATCHDOG


def ensure_started(tick_s: Optional[float] = None,
                   incident_dir: Optional[str] = None,
                   node: str = "",
                   max_bundles: Optional[int] = None) -> Watchdog:
    """Start (or return) the process watchdog. Idempotent; the first
    caller's configuration wins. Env: DGRAPH_TPU_WATCHDOG_TICK_S,
    DGRAPH_TPU_INCIDENT_MAX."""
    global _WATCHDOG
    with _LOCK:
        if _WATCHDOG is not None:
            return _WATCHDOG
    wd = Watchdog(
        tick_s=tick_s if tick_s is not None
        else _env_f("DGRAPH_TPU_WATCHDOG_TICK_S", 1.0),
        incident_dir=incident_dir,
        max_bundles=int(max_bundles if max_bundles is not None
                        else _env_f("DGRAPH_TPU_INCIDENT_MAX", 8)))
    with _LOCK:
        if _WATCHDOG is None:
            _WATCHDOG = wd
        wd = _WATCHDOG
    wd.start(node=node)
    return wd


def stop() -> None:
    """Stop and forget the process watchdog (tests; also resets the
    shared manager so rule state never leaks across tests)."""
    global _WATCHDOG, _MANAGER
    with _LOCK:
        wd, _WATCHDOG = _WATCHDOG, None
        _MANAGER = None
    if wd is not None:
        wd.stop()


def alerts_payload() -> dict:
    """The /debug/alerts + {"op":"alerts"} body. Always valid — a
    node without a started watchdog reports its rule catalog and an
    empty firing set."""
    out = _manager().payload()
    wd = _WATCHDOG
    out["watchdog"] = {
        "running": wd is not None and wd._thread is not None,
        "tick_s": wd.tick_s if wd is not None else None,
        "incident_dir": wd.recorder.root
        if wd is not None and wd.recorder is not None else None}
    return out


def incidents_payload(limit: int = 16,
                      bundle: Optional[str] = None) -> dict:
    """The /debug/incidents + {"op":"incidents"} body: the bundle
    ring's manifests (newest last), or one full bundle by id."""
    wd = _WATCHDOG
    if wd is None or wd.recorder is None:
        return {"incidents": [], "enabled": False}
    if bundle:
        return {"enabled": True, "bundle": wd.recorder.read(bundle)}
    items = wd.recorder.list()
    return {"enabled": True, "incidents": items[-int(limit):]}


def firing_summary() -> list[dict]:
    """Compact firing set for the heat-report piggyback (alphas ship
    this to zero on their existing reports; [] rides free)."""
    return _manager().firing()


def ack(series: str) -> bool:
    return _manager().ack(series)


def silence(series: str, ttl_s: float) -> None:
    _manager().silence(series, ttl_s)
