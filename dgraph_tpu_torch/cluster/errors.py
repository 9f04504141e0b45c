"""Typed cluster routing errors shared by server and client sides.

Lives in its own module so cluster/service.py (raises) and
cluster/client.py (re-raises from the wire) can both import it without
a cycle.
"""

from __future__ import annotations

from typing import Optional


class TabletMisrouted(RuntimeError):
    """The serving group no longer serves this tablet (it moved, or
    split, after the caller fetched its routing map). RETRYABLE by
    contract: the router refreshes the tablet map and re-routes
    (bounded retries) — a user must never see this as a 500.

    Crosses the wire as {"ok": False, "misrouted": {"pred", "group"}}
    (cluster/service.py _client_loop -> cluster/client.py _unwrap)."""

    def __init__(self, pred: str, group: Optional[int] = None,
                 msg: str = ""):
        self.pred = pred
        self.group = group  # new owner if known, else None
        super().__init__(
            msg or f"tablet {pred!r} is not served here"
            + (f" (moved to group {group})" if group else "")
            + "; refresh the tablet map and re-route")


class StaleRead(RuntimeError):
    """A watermark-bounded follower read could not be served: this
    replica's applied watermark has not yet covered the read's granted
    `read_ts` within the staleness bound. RETRYABLE by contract — the
    router retries the read on another replica of the same group (a
    voter, or ultimately the leader, always qualifies) instead of
    surfacing an error or, worse, serving a snapshot older than the
    granted timestamp.

    Crosses the wire as {"ok": False, "stale": {"readTs", "watermark"}}
    (cluster/service.py _client_loop -> cluster/client.py _unwrap)."""

    def __init__(self, read_ts: int, watermark: int, msg: str = ""):
        self.read_ts = read_ts
        self.watermark = watermark
        super().__init__(
            msg or f"replica watermark {watermark} has not reached "
            f"read_ts {read_ts}; retry the read on another replica")


class WriteFenced(RuntimeError):
    """The WHOLE cluster refuses client writes: it is a replication
    standby (state arrives only through the replication stream,
    cluster/replication.py) or a fenced old primary after a standby
    promotion. Reads keep serving. NOT retryable against this
    cluster — the client must re-point at the promoted primary.

    Crosses the wire as {"ok": False, "fenced": {"phase"}}
    (cluster/service.py _client_loop -> cluster/client.py _unwrap)."""

    def __init__(self, phase: str = "", msg: str = ""):
        self.phase = phase
        super().__init__(
            msg or "cluster is write-fenced"
            + (f" (replication phase {phase!r})" if phase else "")
            + ": client writes are refused; "
            "direct writes at the active primary")


# Typed-wire-error registry (dglint DG14): every typed error this
# module defines MUST have a wire serialization arm in
# cluster/service.py _client_loop (an `except Cls` producing the
# listed response key) AND a client re-raise in cluster/client.py
# ClusterClient._unwrap (a `resp.get(key)` branch raising Cls) — a
# typed error missing either half silently degrades to a bare
# RuntimeError 500 at the far edge, which is exactly the
# read-parity/retry-contract bug the types exist to prevent.
WIRE_ERRORS = (
    ("TabletMisrouted", "misrouted"),
    ("StaleRead", "stale"),
    ("WriteFenced", "fenced"),
)
