"""Request context: end-to-end deadlines, cancellation, trace ids.

The reference threads a context.Context from the gRPC/HTTP edge through
edgraph -> query -> worker RPCs, so a client deadline cancels work
everywhere it runs (edgraph/server.go attaches the request ctx;
worker/task.go ProcessTaskOverNetwork forwards it on the wire). This
module is that capability as an explicit object: a `RequestContext`
carries an absolute deadline (monotonic clock), a cancellation flag and
a trace id, and is created once at the serving edge
(`X-Dgraph-Deadline-Ms` header / the gRPC timeout field), threaded
through GraphDB.query/mutate/alter into the executor (checked at
per-block and per-level boundaries), and propagated on the wire to
cross-group federated tasks as a remaining-budget `deadline_ms` so
remote workers inherit the budget with a small skew allowance.

Error mapping at the edges:
  DeadlineExceeded -> HTTP 408 / gRPC DEADLINE_EXCEEDED  (retryable)
  Cancelled        -> HTTP 499 / gRPC CANCELLED
  Overloaded       -> HTTP 429 / gRPC RESOURCE_EXHAUSTED (retryable)

Port of `dgraph_tpu/utils/reqctx.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Optional

# extra budget a remote worker grants on top of the propagated
# remaining_ms: the coordinator's clock read and the RPC hop are not
# free, and a worker that times out a hair before its coordinator
# produces a confusing double error (ref x/x.go GetOutOfOrderTimestamp
# style skew allowances)
PROPAGATION_SKEW_S = 0.05


class RequestAborted(Exception):
    """Base for every give-up-now condition a RequestContext signals."""


class DeadlineExceeded(RequestAborted):
    """The request's deadline passed; work must stop mid-flight."""


class Cancelled(RequestAborted):
    """The request was explicitly cancelled (client gone, admin)."""


class Overloaded(RequestAborted):
    """Admission control shed this request: the server is saturated.

    Retryable by contract (the reference answers RESOURCE_EXHAUSTED
    from its pending-query throttle, edgraph/server.go rateLimiter)."""


class RequestContext:
    """Deadline + cancellation + trace id for one request.

    Cheap to check (`expired` is one monotonic read) so the executor
    can consult it at every traversal level. Thread-safe: the HTTP
    handler thread owns it, but /admin/cancel may cancel from another
    thread.
    """

    __slots__ = ("deadline", "trace_id", "parent_span", "tenant",
                 "_cancel")

    def __init__(self, deadline: Optional[float] = None,
                 trace_id: str = "", parent_span: str = "",
                 tenant: str = ""):
        self.deadline = deadline  # absolute time.monotonic(), or None
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        # span id of the CALLER's span on the other side of the wire
        # (W3C traceparent parent-id / the `parent_span` RPC field):
        # the serving edge binds it so this node's spans link into the
        # originating trace (utils/tracing.bind_request)
        self.parent_span = parent_span or ""
        # ACL namespace / tenant the request bills against (the QoS
        # plane's token-bucket key and the reqlog `tenant` field);
        # empty = untagged, accounted as "default" at admission
        self.tenant = tenant or ""
        self._cancel = threading.Event()

    # -------------------------------------------------- constructors

    @classmethod
    def with_timeout(cls, seconds: Optional[float],
                     trace_id: str = "",
                     parent_span: str = "",
                     tenant: str = "") -> "RequestContext":
        """Context expiring `seconds` from now (None = no deadline)."""
        dl = None if seconds is None else time.monotonic() + max(
            0.0, float(seconds))
        return cls(deadline=dl, trace_id=trace_id,
                   parent_span=parent_span, tenant=tenant)

    @classmethod
    def from_deadline_ms(cls, ms, trace_id: str = "",
                         skew_s: float = 0.0,
                         parent_span: str = "",
                         tenant: str = "") -> "RequestContext":
        """Context from a wire-propagated remaining budget in ms (the
        `deadline_ms` RPC field / `X-Dgraph-Deadline-Ms` header).
        `skew_s` widens the budget for workers inheriting it over the
        network (PROPAGATION_SKEW_S)."""
        return cls.with_timeout(int(ms) / 1000.0 + skew_s,
                                trace_id=trace_id,
                                parent_span=parent_span,
                                tenant=tenant)

    @classmethod
    def background(cls, trace_id: str = "",
                   parent_span: str = "",
                   tenant: str = "") -> "RequestContext":
        """No deadline, cancellable — internal/maintenance work."""
        return cls(deadline=None, trace_id=trace_id,
                   parent_span=parent_span, tenant=tenant)

    # ------------------------------------------------------- queries

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    @property
    def expired(self) -> bool:
        return self.deadline is not None \
            and time.monotonic() >= self.deadline

    def remaining(self) -> Optional[float]:
        """Seconds left (never negative), or None without a deadline."""
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - time.monotonic())

    def remaining_ms(self) -> Optional[int]:
        rem = self.remaining()
        return None if rem is None else int(rem * 1000)

    # ------------------------------------------------------- control

    def cancel(self):
        self._cancel.set()

    def check(self, where: str = ""):
        """Raise if this request must stop. Called at executor
        block/level boundaries, before RPC fan-outs, and between
        mutation phases — the cooperative-cancellation points the
        reference gets from ctx.Err() checks."""
        if self._cancel.is_set():
            raise Cancelled(
                "request cancelled" + (f" at {where}" if where else "")
                + f" (trace {self.trace_id})")
        if self.expired:
            raise DeadlineExceeded(
                "deadline exceeded" + (f" at {where}" if where else "")
                + f" (trace {self.trace_id})")
