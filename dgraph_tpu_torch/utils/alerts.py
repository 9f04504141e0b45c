"""Alert rule engine: SLO burn-rate + stall-watchdog evaluation.

Pure state machines, no threads — utils/watchdog.py owns the tick
loop, signal collection and the incident flight recorder; this module
owns WHAT fires and WHEN. Two rule families:

  BurnRateRule   multi-window error-budget burn (the Google SRE
                 "multiwindow, multi-burn-rate" recipe): a series of
                 per-second (total, bad) buckets per op-class and per
                 tenant, fed from the request log's completion
                 observer; the rule breaches only when BOTH the fast
                 window (default 1 m) and the slow window (default
                 30 m) burn above threshold — the fast window gives
                 detection latency, the slow window keeps a short
                 blip from paging.

  ThresholdRule  a named scalar signal (raft apply lag, WAL fsync
                 p99, CDC subscriber lag, DR standby lag, stuck-move
                 age, result-cache hit collapse, tile-cache thrash,
                 shed rate, silent raft peer) compared against a
                 threshold.

Both carry hysteresis: `for_ticks` consecutive breaching evaluations
to transition to firing, `clear_ticks` consecutive healthy ones to
resolve — a boundary-oscillating signal holds its current state
instead of flapping. Transitions append to a bounded event ring
(`events`), and `evaluate()` returns them so the watchdog can trigger
flight-recorder captures exactly on ok->firing edges.

Thresholds/windows are env-tunable (DGRAPH_TPU_ALERT_*): production
defaults are deliberately conservative (zero false positives on a
healthy cluster is an acceptance gate dgchaos enforces), while chaos
harnesses shrink the windows to fit second-scale fault injection.

Ref: the reference Dgraph ships no alerting (only /health + /state);
the rule catalog is documented in docs/deployment.md "Alerting &
incident response".

Port of `dgraph_tpu/utils/alerts.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Optional

# outcomes that consume error budget: a shed is backpressure working
# as designed, an abort is the transaction protocol working as
# designed, a client cancel is the client's choice — only deadline
# blowouts and real errors are SLO-bad
BAD_OUTCOMES = frozenset({"error", "deadline"})

_EVENTS_MAX = 256


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class SloWindow:
    """Per-second (total, bad) buckets over a fixed horizon — one per
    tracked series (an op class or a tenant). O(1) add; rate queries
    sum the last N seconds. Monotonic-second indexed ring."""

    __slots__ = ("horizon", "_ring")

    def __init__(self, horizon_s: int):
        self.horizon = int(horizon_s)
        # slot = [second, total, bad]; second stamps validity so a
        # sparse series never reads a lapped slot
        self._ring = [[-1, 0, 0] for _ in range(self.horizon)]

    def add(self, now_s: int, bad: bool) -> None:
        slot = self._ring[now_s % self.horizon]
        if slot[0] != now_s:
            slot[0], slot[1], slot[2] = now_s, 0, 0
        slot[1] += 1
        if bad:
            slot[2] += 1

    def rates(self, now_s: int, window_s: int) -> tuple[int, int]:
        """(total, bad) over the window ending at now_s inclusive."""
        window_s = min(int(window_s), self.horizon)
        total = bad = 0
        for s in range(now_s - window_s + 1, now_s + 1):
            slot = self._ring[s % self.horizon]
            if slot[0] == s:
                total += slot[1]
                bad += slot[2]
        return total, bad


class _RuleState:
    __slots__ = ("state", "breach_ticks", "ok_ticks", "idle_ticks",
                 "since", "value", "acked", "silenced_until")

    def __init__(self):
        self.state = "ok"
        self.breach_ticks = 0
        self.ok_ticks = 0
        self.idle_ticks = 0     # consecutive no-data evaluations
        self.since = 0.0        # monotonic ts of the last transition
        self.value = None       # last evaluated value
        self.acked = False
        self.silenced_until = 0.0


class Rule:
    """Base: subclasses implement breached(...) -> (bool|None, value).
    None means "not enough data — hold current state without counting
    toward hysteresis either way"."""

    kind = "threshold"

    def __init__(self, name: str, *, for_ticks: int = 3,
                 clear_ticks: int = 5, severity: str = "page",
                 summary: str = ""):
        self.name = name
        self.for_ticks = max(1, int(for_ticks))
        self.clear_ticks = max(1, int(clear_ticks))
        self.severity = severity
        self.summary = summary

    def describe(self) -> dict:
        return {"rule": self.name, "kind": self.kind,
                "severity": self.severity, "summary": self.summary,
                "for_ticks": self.for_ticks,
                "clear_ticks": self.clear_ticks}


class ThresholdRule(Rule):
    """signal `op` threshold — the stall-watchdog family. `signal`
    names a key in the signals dict the watchdog tick assembles;
    a missing key holds state (the subsystem isn't running here)."""

    def __init__(self, name: str, signal: str, threshold: float,
                 op: str = ">", **kw):
        super().__init__(name, **kw)
        self.signal = signal
        self.threshold = float(threshold)
        self.op = op

    def describe(self) -> dict:
        d = super().describe()
        d.update(signal=self.signal, threshold=self.threshold,
                 op=self.op)
        return d

    def breached(self, signals: dict) -> tuple[Optional[bool], object]:
        v = signals.get(self.signal)
        if v is None:
            return None, None
        if self.op == "<":
            return v < self.threshold, v
        return v > self.threshold, v


class BurnRateRule(Rule):
    """Multi-window error-budget burn over one SloWindow series.

    burn = bad_fraction / error_budget, error_budget = 1 - target.
    Breaches only when burn >= threshold over BOTH windows and the
    fast window saw >= min_volume requests (a two-request blip on an
    idle node is noise, not an outage)."""

    kind = "burn_rate"

    def __init__(self, name: str, *, target: float, burn: float,
                 fast_s: int, slow_s: int, min_volume: int, **kw):
        super().__init__(name, **kw)
        self.target = float(target)
        self.budget = max(1e-6, 1.0 - self.target)
        self.burn = float(burn)
        self.fast_s = int(fast_s)
        self.slow_s = int(slow_s)
        self.min_volume = int(min_volume)

    def describe(self) -> dict:
        d = super().describe()
        d.update(target=self.target, burn=self.burn,
                 fast_s=self.fast_s, slow_s=self.slow_s,
                 min_volume=self.min_volume)
        return d

    def breached_window(self, win: SloWindow, now_s: int
                        ) -> tuple[Optional[bool], object]:
        ft, fb = win.rates(now_s, self.fast_s)
        st, sb = win.rates(now_s, self.slow_s)
        if ft < self.min_volume:
            # not enough traffic to judge: holds state, and a firing
            # alert over a series that went quiet resolves via the
            # manager's idle-series cleanup, not a phantom "healthy"
            return None, None
        fast_burn = (fb / ft) / self.budget
        slow_burn = (sb / st) / self.budget if st else 0.0
        return (fast_burn >= self.burn and slow_burn >= self.burn), \
            round(min(fast_burn, slow_burn), 3)


class AlertManager:
    """Rule registry + per-series state machines + event ring.

    Burn-rate rules fan out over the live series (op classes and
    tenants seen by the request-log observer); threshold rules are
    one series each. All mutation happens under one lock; `evaluate`
    is called from the watchdog tick, `observe_request` from serving
    threads via the reqlog observer (O(1) per request)."""

    MAX_SERIES = 64  # bound per-tenant window growth

    def __init__(self, rules: Optional[list[Rule]] = None,
                 horizon_s: Optional[int] = None):
        self._lock = threading.Lock()
        self.rules: list[Rule] = list(rules if rules is not None
                                      else default_rules())
        slow = max([r.slow_s for r in self.rules
                    if isinstance(r, BurnRateRule)] or [1800])
        self.horizon_s = int(horizon_s or (slow + 60))
        self._windows: dict[str, SloWindow] = {}   # series key -> win
        self._states: dict[str, _RuleState] = {}   # series -> state
        self.events: deque = deque(maxlen=_EVENTS_MAX)
        self._started_mono = time.monotonic()

    # ------------------------------------------------------ ingestion

    def observe_request(self, rec: dict) -> None:
        """reqlog observer: one completed request into the per-second
        windows — per op-class, and per tenant when tagged."""
        outcome = rec.get("outcome", "ok")
        bad = outcome in BAD_OUTCOMES
        now_s = int(time.monotonic())
        op = str(rec.get("op") or "other")
        tenant = str(rec.get("tenant") or "")
        with self._lock:
            self._window("op:" + op).add(now_s, bad)
            self._window("op:_all").add(now_s, bad)
            if tenant:
                self._window("tenant:" + tenant).add(now_s, bad)

    def _window(self, series: str) -> SloWindow:
        win = self._windows.get(series)
        if win is None:
            if len(self._windows) >= self.MAX_SERIES:
                # bounded: drop the oldest tracked series that isn't
                # the aggregate (tenant explosion guard); op:_all
                # always stays
                for victim in self._windows:
                    if victim != "op:_all":
                        del self._windows[victim]
                        break
            win = self._windows[series] = SloWindow(self.horizon_s)
        return win

    # ----------------------------------------------------- evaluation

    def evaluate(self, signals: Optional[dict] = None,
                 now_mono: Optional[float] = None) -> list[dict]:
        """One tick: run every rule, advance hysteresis, return the
        TRANSITIONS ([{rule, series, state, value, ts}...]) — the
        watchdog captures an incident bundle per ok->firing edge."""
        signals = signals or {}
        now = now_mono if now_mono is not None else time.monotonic()
        now_s = int(now)
        transitions: list[dict] = []
        with self._lock:
            for rule in self.rules:
                if isinstance(rule, BurnRateRule):
                    for series, win in list(self._windows.items()):
                        breached, value = rule.breached_window(
                            win, now_s)
                        self._advance(rule, f"{rule.name}[{series}]",
                                      breached, value, now,
                                      transitions)
                else:
                    self._advance(rule, rule.name,
                                  *rule.breached(signals), now,
                                  transitions)
        return transitions

    def _advance(self, rule: Rule, series: str,
                 breached: Optional[bool], value, now: float,
                 out: list[dict]) -> None:
        st = self._states.get(series)
        if st is None:
            if not breached:
                return  # don't materialize state for healthy series
            st = self._states[series] = _RuleState()
        st.value = value
        if breached is None:
            # insufficient data: hold, no hysteresis movement — but a
            # FIRING series that stays data-starved long enough (the
            # traffic evaporated, or the subsystem shut down) resolves
            # rather than paging forever on a ghost
            st.idle_ticks += 1
            if st.state == "firing" \
                    and st.idle_ticks >= 4 * rule.clear_ticks:
                st.state = "ok"
                st.since = now
                out.append(self._event(rule, series, "resolved",
                                       None, now))
            return
        st.idle_ticks = 0
        if breached:
            st.breach_ticks += 1
            st.ok_ticks = 0
            if st.state == "ok" \
                    and st.breach_ticks >= rule.for_ticks \
                    and now >= st.silenced_until:
                st.state = "firing"
                st.since = now
                st.acked = False
                out.append(self._event(rule, series, "firing",
                                       value, now))
        else:
            st.ok_ticks += 1
            st.breach_ticks = 0
            if st.state == "firing" \
                    and st.ok_ticks >= rule.clear_ticks:
                st.state = "ok"
                st.since = now
                out.append(self._event(rule, series, "resolved",
                                       value, now))

    def _event(self, rule: Rule, series: str, state: str, value,
               now: float) -> dict:
        ev = {"rule": rule.name, "series": series, "state": state,
              "value": value, "severity": rule.severity,
              "mono": round(now, 3),
              # wall clock: operators join events against external
              # logs and the incident bundles' manifests
              "ts": time.time()}  # dglint: disable=DG06
        self.events.append(ev)
        return ev

    # -------------------------------------------------------- control

    def ack(self, series: str) -> bool:
        """Mark a firing alert acknowledged (it keeps evaluating and
        still resolves; ack is operator bookkeeping, not a mute)."""
        with self._lock:
            st = self._states.get(series)
            if st is None or st.state != "firing":
                return False
            st.acked = True
            return True

    def silence(self, series: str, ttl_s: float) -> None:
        """Suppress NEW firings of a series for ttl_s (an already-
        firing alert resolves normally; it just can't re-fire)."""
        with self._lock:
            st = self._states.setdefault(series, _RuleState())
            st.silenced_until = time.monotonic() + float(ttl_s)

    # ------------------------------------------------------- payloads

    def firing(self) -> list[dict]:
        with self._lock:
            return [{"series": s, "rule": s.split("[", 1)[0],
                     "value": st.value, "acked": st.acked,
                     "since_s": round(time.monotonic() - st.since, 1)}
                    for s, st in sorted(self._states.items())
                    if st.state == "firing"]

    def payload(self) -> dict:
        """The /debug/alerts body: rule catalog, firing set, recent
        transition events."""
        firing = self.firing()
        with self._lock:
            events = list(self.events)[-64:]
        return {"rules": [r.describe() for r in self.rules],
                "firing": firing, "events": events,
                "uptime_s": round(
                    time.monotonic() - self._started_mono, 1)}


def default_rules() -> list[Rule]:
    """The shipped rule catalog (docs/deployment.md has the prose
    version). Every number here is env-tunable: production defaults
    are conservative — the dgchaos acceptance gate requires ZERO
    firings on a healthy cluster — while chaos smokes shrink windows
    to match second-scale fault injection."""
    for_t = int(_env_f("DGRAPH_TPU_ALERT_FOR_TICKS", 3))
    clear_t = int(_env_f("DGRAPH_TPU_ALERT_CLEAR_TICKS", 5))
    hy = dict(for_ticks=for_t, clear_ticks=clear_t)
    return [
        BurnRateRule(
            "slo_error_burn",
            target=_env_f("DGRAPH_TPU_ALERT_SLO_TARGET", 0.99),
            burn=_env_f("DGRAPH_TPU_ALERT_SLO_BURN", 10.0),
            fast_s=int(_env_f("DGRAPH_TPU_ALERT_SLO_FAST_S", 60)),
            slow_s=int(_env_f("DGRAPH_TPU_ALERT_SLO_SLOW_S", 1800)),
            min_volume=int(_env_f(
                "DGRAPH_TPU_ALERT_SLO_MIN_VOLUME", 20)),
            summary="error-budget burn (deadline/error outcomes) "
                    "over fast AND slow windows", **hy),
        ThresholdRule(
            "raft_apply_lag", "raft_apply_lag",
            _env_f("DGRAPH_TPU_ALERT_APPLY_LAG", 5000),
            summary="committed-applied raft entries: the apply path "
                    "has stalled behind consensus", **hy),
        ThresholdRule(
            "raft_peer_silent", "raft_peer_silent_s",
            _env_f("DGRAPH_TPU_ALERT_PEER_SILENT_S", 10.0),
            summary="seconds since the quietest raft peer was heard "
                    "(several election timeouts = a partition)", **hy),
        ThresholdRule(
            "report_silent", "report_silent_s",
            _env_f("DGRAPH_TPU_ALERT_REPORT_SILENT_S", 90.0),
            summary="seconds since the quietest alpha's heat/status "
                    "report reached zero (node down or partitioned "
                    "from the coordinator; works at replicas=1)",
            **hy),
        ThresholdRule(
            "wal_fsync_stall", "wal_fsync_p99_s",
            _env_f("DGRAPH_TPU_ALERT_FSYNC_P99_S", 0.5),
            summary="WAL fsync p99 over the last tick window: the "
                    "durability volume is dying", **hy),
        ThresholdRule(
            "cdc_lag", "cdc_max_lag",
            _env_f("DGRAPH_TPU_ALERT_CDC_LAG", 10000),
            summary="slowest CDC subscriber's unread entries", **hy),
        ThresholdRule(
            "dr_standby_lag", "dr_lag_entries",
            _env_f("DGRAPH_TPU_ALERT_DR_LAG", 10000),
            summary="cross-cluster standby replication lag", **hy),
        ThresholdRule(
            "move_stuck", "move_stuck_age_s",
            _env_f("DGRAPH_TPU_ALERT_MOVE_STUCK_S", 600.0),
            summary="a tablet move/split has sat in one phase too "
                    "long", **hy),
        ThresholdRule(
            "result_cache_collapse", "result_cache_hit_frac",
            _env_f("DGRAPH_TPU_ALERT_CACHE_HIT_FRAC", 0.02),
            op="<",
            summary="result-cache hit rate collapsed under real "
                    "lookup volume (invalidation storm)", **hy),
        ThresholdRule(
            "tile_cache_thrash", "tile_evictions_per_s",
            _env_f("DGRAPH_TPU_ALERT_TILE_EVICT_S", 200.0),
            summary="device tile-cache evictions/s: working set no "
                    "longer fits", **hy),
        ThresholdRule(
            "shed_rate", "sheds_per_s",
            _env_f("DGRAPH_TPU_ALERT_SHED_S", 10.0),
            summary="admission sheds/s (global + tenant QoS): "
                    "sustained overload", **hy),
    ]


# nothing here touches the process-global metrics/reqlog state: the
# watchdog owns the one shared AlertManager instance per process
_SIGNAL_DOC: dict[str, str] = {
    "raft_apply_lag": "cluster/service.py _drain_ready",
    "raft_peer_silent_s": "RaftServer.peer_ages max",
    "report_silent_s": "zero leader's per-alpha heat-report clock",
    "wal_fsync_p99_s": "dgraph_wal_fsync_seconds tick-delta p99",
    "cdc_max_lag": "cdc/changelog.py stats() subscriber lag",
    "dr_lag_entries": "dgraph_repl_lag_entries gauge max",
    "move_stuck_age_s": "zero move ledger phase age",
    "result_cache_hit_frac": "result-cache counters tick delta",
    "tile_evictions_per_s": "device_cache_evictions tick delta",
    "sheds_per_s": "shed counters tick delta",
}

SignalFn = Callable[[], dict]
