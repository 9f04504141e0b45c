"""Open-loop arrival scheduler + latency summarizers.

Closed-loop harnesses (N workers, each firing the next request the
moment the last returns) measure service time, not latency under
offered load: when the server slows down, a closed loop *slows its own
arrival rate* and hides the queue. An open loop fixes the arrival
schedule up front — latency is measured from the SCHEDULED arrival, so
time spent queueing behind a saturated server counts (the
coordinated-omission correction; the reference load-tests the same way
with its `dgraph counter`/increment traffic tools at fixed rates,
SURVEY §4.5).

Factored out of bench_queries.py --concurrency so the single-node
batching gate, the cluster harness (tools/dgbench.py) and the CI load
smoke share ONE definition of "offered load" and "p99".

Port of `dgraph_tpu/bench/openloop.py`: a copy (standard library and
numpy only).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence


def run_open_loop(submit: Callable, reqs: Sequence,
                  concurrency: int, rate_qps: float,
                  burst_of: Optional[Sequence[int]] = None,
                  results: Optional[list] = None,
                  arrivals_out: Optional[list] = None) -> list[float]:
    """Drive `submit(req)` over one global open-loop schedule.

    One arrival schedule at `rate_qps` offered load; `concurrency`
    workers pull the next request as they free up; latency[i] =
    finish - SCHEDULED arrival (queueing counts, the open-loop
    property). `burst_of[i]` assigns request i to an arrival slot —
    requests sharing a slot arrive at the same instant (fan-out
    bursts). With `results` (a caller list), submit's return value is
    appended as results[i] = (index, value) — dgbench uses it to
    classify outcomes without wrapping submit in another closure.
    With `arrivals_out` (a caller list), the absolute scheduled
    arrival times (time.perf_counter clock) are appended before
    driving starts — tools/dgchaos.py aligns them against its
    nemesis timeline instead of re-deriving the schedule.
    """
    t0 = time.perf_counter() + 0.05
    if burst_of is None:
        arrivals = [t0 + i / rate_qps for i in range(len(reqs))]
    else:
        slots = burst_of[-1] + 1
        slot_rate = rate_qps * slots / len(reqs)
        arrivals = [t0 + s / slot_rate for s in burst_of]
    if arrivals_out is not None:
        arrivals_out.extend(arrivals)
    lat = [0.0] * len(reqs)
    nxt = [0]
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = nxt[0]
                if i >= len(reqs):
                    return
                nxt[0] += 1
            wait = arrivals[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            out = submit(reqs[i])
            lat[i] = time.perf_counter() - arrivals[i]
            if results is not None:
                with lock:
                    results.append((i, out))

    threads = [threading.Thread(target=worker)
               for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return lat


def percentiles(lat: Sequence[float]) -> dict:
    """The BENCH_BATCH.json column shape: p50/p99/mean in ms."""
    import numpy as np

    a = np.asarray(lat) * 1e3
    return {"p50_ms": round(float(np.percentile(a, 50)), 3),
            "p99_ms": round(float(np.percentile(a, 99)), 3),
            "mean_ms": round(float(a.mean()), 3)}


def latency_summary(lat: Sequence[float]) -> dict:
    """The full distribution dgbench reports per op class / outcome:
    percentiles() plus the tail (p90/p999/max) and the count."""
    import numpy as np

    if not len(lat):
        return {"count": 0}
    a = np.asarray(lat) * 1e3
    out = percentiles(lat)
    out.update({
        "count": int(len(a)),
        "p90_ms": round(float(np.percentile(a, 90)), 3),
        "p999_ms": round(float(np.percentile(a, 99.9)), 3),
        "max_ms": round(float(a.max()), 3),
    })
    return out


def occupancy(total_requests: int, dispatches: float) -> float:
    """Mean batch occupancy from a request count and a dispatch
    counter delta (the micro-batcher's efficiency summary)."""
    return round(total_requests / max(dispatches, 1), 2)
