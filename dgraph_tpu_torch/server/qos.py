"""Per-tenant QoS: token-bucket admission layered on --max-pending.

The global `--max-pending` plane (server/http.py _admit /
cluster/service.py handle_request) sheds load when the WHOLE node is
saturated, but it is tenant-blind: one hot tenant's burst consumes the
entire pending budget and every other tenant starves behind it. This
module adds the per-ACL-namespace layer the reference grew as
`--limit normalize-node / query-limit` style knobs: each tenant owns a
token bucket refilled at `rate` requests/second up to `burst` tokens,
checked BEFORE the global pending gate, so a tenant exceeding its
sustained rate degrades to typed Overloaded (HTTP 429, retryable) while
the rest of the cluster's tenants keep their full budget.

Buckets are created lazily on first sight of a tenant and refilled on
access (no background thread): a bucket's level at time t is
min(burst, level + (t - last) * rate). The clock is injectable so tests
drive refill deterministically.

Port of `dgraph_tpu/server/qos.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

# a server should not hold bucket state for unboundedly many tenant
# names (the tenant field is client-supplied): beyond this many
# distinct tenants the least-recently-seen bucket is evicted — a
# re-created bucket starts FULL, which only ever errs toward admitting
_MAX_TENANTS = 4096


class TenantQos:
    """Per-tenant token buckets: admit(tenant) -> bool.

    `rate` tokens/second sustained, `burst` tokens of headroom
    (burst <= 0 means burst = rate: one second of slack). A single
    lock guards the bucket map — admission is one dict lookup plus
    arithmetic, far off any hot path's critical section.
    """

    def __init__(self, rate: float, burst: float = 0.0,
                 clock: Optional[Callable[[], float]] = None):
        if rate <= 0:
            raise ValueError("TenantQos rate must be > 0")
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else float(rate)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        # tenant -> [level, last_refill]; dict order doubles as the
        # LRU for the _MAX_TENANTS bound (move-to-end on access)
        self._buckets: dict[str, list[float]] = {}

    def admit(self, tenant: str, cost: float = 1.0) -> bool:
        """Spend `cost` tokens from `tenant`'s bucket; False = shed.

        A shed request spends nothing: the tenant's next request after
        the refill interval is admitted rather than pushed further
        into debt (no negative levels — rejected work must not delay
        recovery)."""
        now = self._clock()
        with self._lock:
            b = self._buckets.pop(tenant, None)
            if b is None:
                b = [self.burst, now]
            else:
                level, last = b
                b = [min(self.burst,
                         level + max(0.0, now - last) * self.rate),
                     now]
            ok = b[0] >= cost
            if ok:
                b[0] -= cost
            self._buckets[tenant] = b  # re-insert = move to LRU tail
            if len(self._buckets) > _MAX_TENANTS:
                self._buckets.pop(next(iter(self._buckets)))
            return ok

    def level(self, tenant: str) -> float:
        """Current token level (refilled to now) — for tests/dgtop."""
        now = self._clock()
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                return self.burst
            level, last = b
            return min(self.burst,
                       level + max(0.0, now - last) * self.rate)

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._buckets)
