"""On-demand wall-clock sampling profiler (`/debug/pprof?seconds=N`).

The reference ships Go's net/http/pprof on every node (x/metrics.go
pprof mux); this is the Python analogue the runtime actually needs: a
sampling profiler an operator can point at a LOADED node without
restarting it or paying always-on instrumentation. `collect()` wakes
`hz` times a second, snapshots every thread's stack via
`sys._current_frames()`, and aggregates identical stacks; the result
renders as collapsed-stack text (flamegraph.pl / speedscope paste) or
speedscope's sampled-profile JSON (one profile per thread).

Wall-clock on purpose: a thread blocked on a lock, a socket or the
GIL is exactly what "where did my p99 go" needs to show — a CPU-only
profile of a Python server under IO hides the story.

Cost model (bench_micro.py --pprof-overhead gates it): each sample
holds the GIL for one frames() walk, so overhead ≈ hz x per-sample
walk time. At the default 100 Hz over a few dozen threads that is
well under the 2% budget; `seconds` and `hz` are clamped so a typo'd
request cannot turn the profiler into a DoS.

Port of `dgraph_tpu/utils/pprof.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter

DEFAULT_HZ = 100
MAX_SECONDS = 120.0
MAX_HZ = 1000

_PROFILE_LOCK = threading.Lock()  # one collection at a time per process


class Profile:
    """Aggregated samples: {(thread_name, (frame, ...)): count} with
    frames root-first. Frame identity is (function, file, firstlineno)
    — the function, not the currently-executing line — so one hot
    function aggregates to one frame regardless of which bytecode its
    samples landed on (standard sampling-profiler aggregation)."""

    def __init__(self, stacks: Counter, samples: int, hz: int,
                 seconds: float, node: str = ""):
        self.stacks = stacks
        self.samples = samples
        self.hz = hz
        self.seconds = seconds
        self.node = node

    # ---------------------------------------------------------- renders

    def collapsed(self) -> str:
        """Brendan-Gregg collapsed-stack text: one line per distinct
        (thread, stack), `thread;frame;frame;... count`, sorted for a
        stable, diffable artifact."""
        lines = []
        for (tname, frames), n in sorted(self.stacks.items()):
            lines.append(";".join((tname,) + frames) + f" {n}")
        return "\n".join(lines) + ("\n" if lines else "")

    def speedscope(self) -> dict:
        """speedscope file-format JSON: one "sampled" profile per
        thread, weights in seconds (sample count / hz), shared frame
        table. Load at https://www.speedscope.app or `speedscope f`."""
        frame_ix: dict[str, int] = {}
        frames: list[dict] = []

        def ix(frame: str) -> int:
            got = frame_ix.get(frame)
            if got is None:
                got = frame_ix[frame] = len(frames)
                name, _, loc = frame.partition(" (")
                rec: dict = {"name": name}
                if loc.endswith(")"):
                    fname, _, line = loc[:-1].rpartition(":")
                    rec["file"] = fname
                    try:
                        rec["line"] = int(line)
                    except ValueError:
                        pass
                frames.append(rec)
            return got

        by_thread: dict[str, list[tuple[tuple, int]]] = {}
        for (tname, stack), n in sorted(self.stacks.items()):
            by_thread.setdefault(tname, []).append((stack, n))
        profiles = []
        for tname in sorted(by_thread):
            samples, weights = [], []
            total = 0.0
            for stack, n in by_thread[tname]:
                samples.append([ix(f) for f in stack])
                w = n / max(self.hz, 1)
                weights.append(w)
                total += w
            profiles.append({
                "type": "sampled", "name": tname, "unit": "seconds",
                "startValue": 0, "endValue": round(total, 6),
                "samples": samples, "weights": weights})
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "shared": {"frames": frames},
            "profiles": profiles,
            "activeProfileIndex": 0,
            "exporter": "dgraph-tpu-pprof",
            "name": (f"{self.node or 'node'} wall "
                     f"{self.seconds:g}s @ {self.hz}Hz"),
        }

    def to_payload(self, fmt: str = "speedscope") -> dict:
        """The /debug/pprof response body (HTTP and cluster wire):
        metadata + the requested render(s)."""
        out = {"samples": self.samples, "hz": self.hz,
               "seconds": self.seconds, "node": self.node,
               "threads": len({t for t, _ in self.stacks})}
        if fmt in ("collapsed", "both"):
            out["collapsed"] = self.collapsed()
        if fmt in ("speedscope", "both"):
            out["speedscope"] = self.speedscope()
        return out


# code object -> rendered frame id. The sampler's per-sample cost IS
# the profiler's overhead (each walk holds the GIL), and string
# formatting dominates a cold walk — memoizing by code object makes
# the steady-state walk a dict hit per frame. Code objects are
# immortal for the life of their module; the map stays small.
_FRAME_IDS: dict = {}


def _frame_id(code) -> str:
    got = _FRAME_IDS.get(code)
    if got is not None:
        return got
    fname = code.co_filename
    # trim to the package-relative tail: absolute prefixes differ per
    # deploy and would fragment cross-node aggregation
    for marker in ("/dgraph_tpu_torch/", "/tools/", "/tests/"):
        at = fname.rfind(marker)
        if at >= 0:
            fname = fname[at + 1:]
            break
    else:
        fname = fname.rsplit("/", 1)[-1]
    got = f"{code.co_name} ({fname}:{code.co_firstlineno})"
    _FRAME_IDS[code] = got
    return got


def sample_once(skip_idents: frozenset,
                names: dict[int, str]) -> list[tuple[str, tuple]]:
    """One snapshot of every thread's stack (root-first), skipping the
    profiler's own thread(s). Split out so the overhead bench measures
    exactly the per-sample cost the collect loop pays."""
    out = []
    for ident, frame in sys._current_frames().items():
        if ident in skip_idents:
            continue
        stack = []
        f = frame
        while f is not None:
            stack.append(_frame_id(f.f_code))
            f = f.f_back
        out.append((names.get(ident, f"thread-{ident}"),
                    tuple(reversed(stack))))
    return out


def collect(seconds: float, hz: int = DEFAULT_HZ,
            node: str = "") -> Profile:
    """Sample every live thread for `seconds` at `hz`. Runs in the
    CALLING thread (the debug endpoint's request thread blocks for the
    duration — that is the /debug/pprof?seconds=N contract, same as Go
    pprof's ?seconds=). Serialized process-wide: two concurrent
    collections would double the sampling overhead and each blame the
    other's walk time."""
    seconds = max(0.1, min(float(seconds), MAX_SECONDS))
    hz = max(1, min(int(hz), MAX_HZ))
    interval = 1.0 / hz
    me = frozenset({threading.get_ident()})
    stacks: Counter = Counter()
    samples = 0
    with _PROFILE_LOCK:
        end = time.monotonic() + seconds
        next_at = time.monotonic()
        while time.monotonic() < end:
            names = {t.ident: t.name for t in threading.enumerate()
                     if t.ident is not None}
            for rec in sample_once(me, names):
                stacks[rec] += 1
            samples += 1
            next_at += interval
            delay = next_at - time.monotonic()
            if delay > 0:
                # the inter-sample pacing IS the critical section:
                # _PROFILE_LOCK exists to serialize whole collections
                # (overlapping samplers double overhead and blame each
                # other), so sleeping under it is the contract
                time.sleep(delay)  # dglint: disable=DG04
            else:
                next_at = time.monotonic()  # fell behind: don't burst
    return Profile(stacks, samples, hz, seconds, node=node)


def handle_params(params: dict, node: str = "",
                  default_seconds: float = 1.0) -> dict:
    """Shared /debug/pprof parameter handling for every surface (HTTP
    server, node debug listener, cluster wire op): seconds=, hz=,
    format=collapsed|speedscope|both."""
    seconds = float(params.get("seconds", default_seconds))
    hz = int(params.get("hz", DEFAULT_HZ))
    fmt = str(params.get("format", "speedscope"))
    if fmt not in ("collapsed", "speedscope", "both"):
        raise ValueError(
            f"format must be collapsed/speedscope/both, got {fmt!r}")
    return collect(seconds, hz=hz, node=node).to_payload(fmt)
