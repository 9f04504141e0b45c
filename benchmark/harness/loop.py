"""The closed loop that drives a cell's entry.

A client keeps `in_flight` requests out: it dispatches that many, then
waits for the oldest, and as each returns (its result on the host) it
dispatches the next, until the window's time is up; then it waits for
those still out. A request's latency runs from its dispatch to its
result on the host. The window runs from the first dispatch to the last
result, so a rate taken over it counts all the work and all the time.
"""

from __future__ import annotations

import time
from collections import deque


def closed_loop(entry, seconds: float | None = None, count: int | None = None,
                start: int = 0) -> tuple[list[float], float]:
    """Drive `entry` (its `in_flight`, `dispatch(i)` and `wait(handle)`)
    for `seconds`, or for `count` requests, with request numbers from
    `start`. Returns each completed request's latency in seconds, in
    order of completion, and the window's seconds."""
    out: deque = deque()
    lat: list[float] = []
    nxt = start
    t_start = time.perf_counter()
    t_stop = t_start + seconds if seconds is not None else None

    def more() -> bool:
        if t_stop is not None:
            return time.perf_counter() < t_stop
        return nxt - start < count

    def send() -> None:
        nonlocal nxt
        t = time.perf_counter()
        out.append((t, entry.dispatch(nxt)))
        nxt += 1

    while len(out) < entry.in_flight and more():
        send()
    while out:
        t, h = out.popleft()
        entry.wait(h)
        lat.append(time.perf_counter() - t)
        if more():
            send()
    return lat, time.perf_counter() - t_start
