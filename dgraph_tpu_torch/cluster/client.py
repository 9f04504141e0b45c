"""Cluster client: leader-following RPC over the wire protocol.

The reference's clients (dgo) dial any Alpha and gRPC routes writes to
the group leader internally; our server instead answers
{"ok": False, "leader": id} and the client re-dials — same effect, one
hop visible. Retries cover elections in progress and nodes that just
died (conn/pool.go reconnect behavior).

Port of `dgraph_tpu/cluster/client.py`: a copy, its imports pointed at
this package.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Optional

import random

from dgraph_tpu_torch import wire
from dgraph_tpu_torch.utils import netfault, tracing
from dgraph_tpu_torch.utils.reqctx import Cancelled, DeadlineExceeded, Overloaded

# wire `aborted` field -> the typed error the serving node raised, so
# a coordinator's retry loop (or the HTTP edge's 408/499/429 mapping)
# sees cancellation as cancellation, not a generic RuntimeError
_ABORT_TYPES = {"DeadlineExceeded": DeadlineExceeded,
                "Cancelled": Cancelled,
                "Overloaded": Overloaded}


class ClusterClient:
    """Talks to an Alpha group or a Zero quorum (same protocol)."""

    # seconds a node stays demoted after a connection-level failure —
    # the client-side analogue of the reference's heartbeat health
    # gating (conn/pool.go:227 MonitorHealth marks pools unhealthy;
    # processWithBackupRequest avoids sick replicas)
    UNHEALTHY_S = 1.0

    # bounded-jitter backoff between full routing passes when no node
    # answered (partition, election in progress): starts near-instant
    # so a quick election costs one cheap retry, doubles toward the
    # cap so a PARTITIONED client stops hammering dead links, and the
    # jitter de-synchronizes the reconnect stampede when the partition
    # heals (every waiting client would otherwise redial in lockstep).
    # The chaos harness surfaced the fixed 0.1s sleep this replaces:
    # under a 30s-timeout client it burned a full routing pass — dials
    # included — every 100ms for the whole partition.
    BACKOFF_BASE_S = 0.02
    BACKOFF_CAP_S = 0.5

    def __init__(self, addrs: dict[int, tuple[str, int]],
                 timeout: float = 10.0):
        self.addrs = dict(addrs)
        self.timeout = timeout
        self._conns: dict[int, socket.socket] = {}
        self._preferred: Optional[int] = None
        self._down: dict[int, float] = {}  # node -> demoted-until
        # `_lock` guards ONLY the routing state (addrs/_preferred/
        # _down/_conns/_mus dict shape) and is never held across
        # socket I/O: one caller stuck on a sick peer must not
        # serialize every other caller's routing. Per-node `_mus`
        # mutexes serialize the frame write/read pair on the ONE
        # pooled request/response connection per peer.
        self._lock = threading.Lock()
        self._mus: dict[int, threading.Lock] = {}
        self._closed = False

    # ------------------------------------------------------------ plumbing

    def _node_mu(self, node: int) -> threading.Lock:
        with self._lock:
            mu = self._mus.get(node)
            if mu is None:
                mu = self._mus[node] = threading.Lock()
            return mu

    def _drop(self, node: int,
              sock: Optional[socket.socket] = None) -> bool:
        """Drop a failed pooled conn. With `sock` given, un-pool only
        if THAT socket is still the pooled one — an error surfacing on
        a stale handle must not destroy a healthy replacement another
        thread just dialed. Returns whether `sock` was still current
        (a stale failure says nothing about the node's health)."""
        with self._lock:
            cur = self._conns.get(node)
            current = cur is not None and (sock is None or cur is sock)
            if current:
                del self._conns[node]
            else:
                cur = None
        if cur is not None:
            cur.close()
        if sock is not None and sock is not cur:
            sock.close()  # already un-pooled; close our failed handle
        return current

    def _mark_down(self, node: int):
        with self._lock:
            self._down[node] = time.monotonic() + self.UNHEALTHY_S

    def _rpc_once(self, node: int, req: dict,
                  timeout: Optional[float] = None) -> Optional[dict]:
        """One framed RPC. `timeout` caps THIS attempt's socket waits
        (a caller deadline must bound blocking reads, not just the
        between-attempts loop check); the pooled socket's default
        timeout is restored on success, and a timed-out socket is
        dropped by the except path anyway.

        Locking: the pooled conn is dialed OUTSIDE any lock and
        inserted race-checked (transport.py's DG04 pattern — a 2s
        connect timeout to one dead peer must not block routing to
        healthy ones), then the per-node mutex serializes exactly the
        write+read pair so concurrent requests to one peer cannot
        interleave frames."""
        with self._lock:
            sock = self._conns.get(node)
            addr = self.addrs.get(node)
        if addr is None:
            return None
        if netfault.armed() \
                and netfault.act(addr, can_dup=False) == netfault.DROP:
            # the fault plane cut this link (utils/netfault.py): behave
            # exactly like a refused dial / reset connection — drop the
            # pooled socket, demote the node, let the routing loop try
            # the other replicas. Client->server partitions and every
            # server-side outbound RPC (alpha->zero ts, federated
            # tasks, 2PC stage/finalize) flow through here.
            if sock is not None:
                self._drop(node, sock)
            self._mark_down(node)
            return None
        if sock is None:
            # connect budget never exceeds the client's deadline: a
            # SYN-blackholed peer must not eat a 2s connect timeout
            # on a 150ms-budget timestamp client
            budget = self.timeout if timeout is None \
                else min(self.timeout, timeout)
            try:
                fresh = socket.create_connection(
                    addr, timeout=min(2.0, budget))
                fresh.settimeout(self.timeout)
            except OSError:
                self._mark_down(node)
                return None
            with self._lock:
                if self._closed:
                    # a racing close() already swept the pool; do not
                    # leak a fresh conn into a dead client
                    cur = None
                elif (cur := self._conns.get(node)) is None:
                    self._conns[node] = fresh
                    cur = fresh
                sock = cur
            if sock is not fresh:
                fresh.close()
            if sock is None:
                return None
        try:
            with self._node_mu(node):
                if timeout is not None:
                    sock.settimeout(
                        max(0.001, min(self.timeout, timeout)))
                wire.write_frame(sock, wire.dumps(req))
                resp = wire.loads(wire.read_frame(sock))
                if timeout is not None:
                    sock.settimeout(self.timeout)
            with self._lock:
                self._down.pop(node, None)
            return resp
        except socket.timeout:
            current = self._drop(node, sock)
            if current and (timeout is None
                            or timeout >= self.timeout):
                # a FULL-budget timeout says the node is sick; one cut
                # short by the caller's nearly-spent deadline says
                # nothing — demoting on it would poison the health
                # cache for every other user of this client
                self._mark_down(node)
            return None
        except (OSError, EOFError, wire.WireError):
            if self._drop(node, sock):
                self._mark_down(node)
            return None

    def request(self, req: dict, deadline_s: Optional[float] = None) -> dict:
        """Route to the leader, following hints and retrying through
        elections until the deadline. When the calling context is
        inside a trace (tracing.bind / an open span), the RPC records
        an `rpc.send` span and ships `trace_id`/`parent_span` on the
        wire so the serving node's spans join the originating trace
        (ref worker/task.go forwarding the request context)."""
        if tracing.current() is None:
            return self._request(req, deadline_s)
        with tracing.span("rpc.send", op=str(req.get("op", ""))):
            return self._request(self._traced(req), deadline_s)

    @staticmethod
    def _traced(req: dict) -> dict:
        """Copy of `req` carrying the active trace context: the remote
        `rpc.recv` span parents under OUR innermost span (here: the
        rpc.send span the caller just opened)."""
        cur = tracing.current()
        if cur is None:
            return req
        req = dict(req)
        req.setdefault("trace_id", cur[0])
        req["parent_span"] = cur[1]
        return req

    def _request(self, req: dict,
                 deadline_s: Optional[float] = None) -> dict:
        # an EXHAUSTED budget (0.0) must fail fast, not silently widen
        # to the default timeout — 0.0 is falsy but meaningful
        deadline = time.monotonic() + (
            self.timeout if deadline_s is None else deadline_s)
        # with an explicit budget, every attempt's SOCKET waits are
        # capped by what remains — a peer that accepts then stalls
        # mid-response must not hold an expired caller for the pooled
        # default timeout
        bounded = deadline_s is not None

        def attempt_timeout():
            return max(0.001, deadline - time.monotonic()) \
                if bounded else None

        last_err = "unreachable"
        passes = 0
        while time.monotonic() < deadline:
            # snapshot the routing state under the lock, then do every
            # RPC with NO lock held (the dial-outside-lock pattern: a
            # caller routing through a sick peer, or backing off, must
            # never serialize concurrent callers). Each pass
            # recomputes the candidate order from the CURRENT
            # _preferred/_down/addrs state, which may have moved.
            with self._lock:
                order = [n for n in
                         ([self._preferred] + sorted(self.addrs))
                         if n is not None]
                # recently failed nodes go LAST, not skipped — if every
                # replica is demoted they are all still tried
                now = time.monotonic()
                order = sorted(order,
                               key=lambda n: self._down.get(n, 0) > now)
                known = set(self.addrs)
            seen: set[int] = set()
            for node in order:
                if node in seen or node not in known:
                    continue
                if time.monotonic() >= deadline:
                    break
                seen.add(node)
                resp = self._rpc_once(node, req,
                                      timeout=attempt_timeout())
                if resp is None:
                    continue
                if resp.get("ok"):
                    with self._lock:
                        self._preferred = node
                    return resp
                if resp.get("error") == "not leader":
                    hint = resp.get("leader")
                    with self._lock:
                        follow = (hint is not None and hint != node
                                  and hint in self.addrs)
                        if follow:
                            self._preferred = hint
                    if follow and time.monotonic() < deadline:
                        hinted = self._rpc_once(
                            hint, req, timeout=attempt_timeout())
                        if hinted is not None and hinted.get("ok"):
                            return hinted
                    continue
                return resp  # real application error: surface it
            last_err = "no leader reachable"
            # bounded-jitter exponential backoff, never past the
            # caller's deadline (an expired budget exits the loop and
            # surfaces TYPED as DeadlineExceeded via deadline_expired)
            time.sleep(min(self._backoff_s(passes),
                           max(0.0, deadline - time.monotonic())))
            passes += 1
        # with a caller-supplied budget this is EXPIRY, not a
        # generic routing failure: the marker lets _unwrap raise
        # DeadlineExceeded so the HTTP edge answers 408 retryable
        # instead of 500 (elections in progress eat exactly this
        # path)
        return {"ok": False, "error": last_err,
                "deadline_expired": bounded}

    @classmethod
    def _backoff_s(cls, passes: int,
                   rng: random.Random = random) -> float:
        """Sleep before routing pass `passes+1`: BASE * 2^passes
        capped at CAP, scaled by uniform[0.5, 1.0) jitter. Pure (given
        an rng) so the bound is testable: always > 0, never above
        CAP."""
        step = min(cls.BACKOFF_CAP_S,
                   cls.BACKOFF_BASE_S * (1 << min(passes, 16)))
        return step * (0.5 + rng.random() * 0.5)

    def close(self):
        with self._lock:
            self._closed = True
            socks = list(self._conns.values())
            self._conns.clear()
        for sock in socks:
            sock.close()

    # ------------------------------------------------------- alpha surface

    def query(self, q: str, variables: Optional[dict] = None,
              hedge_s: Optional[float] = None,
              read_ts: Optional[int] = None,
              deadline_ms: Optional[int] = None,
              best_effort: bool = False,
              tenant: str = "") -> dict:
        """Snapshot read from any replica. With hedge_s set, a backup
        request fires at a second replica if the first hasn't answered
        within the delay and the first response wins — the reference's
        processWithBackupRequest (worker/task.go:66) tail-latency
        defense. `deadline_ms` rides the wire so the serving node
        inherits the remaining budget, AND bounds the client-side
        routed-retry loop to the same clock.

        `best_effort` + `read_ts` is the watermark-bounded follower
        read: ANY replica (learners included) serves it once its
        applied watermark covers read_ts, failing typed (StaleRead)
        instead of blocking past the staleness bound."""
        req = {"op": "query", "q": q, "vars": variables}
        if tenant:
            req["tenant"] = tenant
        if deadline_ms is not None:
            req["deadline_ms"] = int(deadline_ms)
        if best_effort:
            req["be"] = True
        if read_ts is not None:
            req["read_ts"] = read_ts
            if hedge_s is not None and not best_effort:
                # pinned reads are leader-only; the hedge path fires at
                # arbitrary replicas with no leader rerouting
                raise ValueError(
                    "read_ts and hedge_s cannot be combined")
        deadline_s = deadline_ms / 1000.0 \
            if deadline_ms is not None else None
        if hedge_s is not None and len(self.addrs) > 1:
            return self._unwrap(self._hedged(req, hedge_s, deadline_s))
        return self._unwrap(self.request(req, deadline_s=deadline_s))

    def query_at(self, node: int, q: str,
                 variables: Optional[dict] = None,
                 read_ts: Optional[int] = None,
                 deadline_ms: Optional[int] = None,
                 tenant: str = "") -> dict:
        """Best-effort snapshot read at ONE specific replica — the
        read-pool path: RoutedCluster spreads reads across
        voters+learners and retries StaleRead/unreachable elsewhere.
        No leader-following (a follower read is served wherever it
        lands or fails typed); ConnectionError = try another replica."""
        req = {"op": "query", "q": q, "vars": variables, "be": True}
        if tenant:
            req["tenant"] = tenant
        if read_ts is not None:
            req["read_ts"] = int(read_ts)
        if deadline_ms is not None:
            req["deadline_ms"] = int(deadline_ms)
        timeout = deadline_ms / 1000.0 \
            if deadline_ms is not None else None
        resp = self._rpc_once(node, self._traced(req), timeout=timeout)
        if resp is None:
            raise ConnectionError(f"replica {node} unreachable")
        return self._unwrap(resp)

    def _hedged(self, req: dict, hedge_s: float,
                deadline_s: Optional[float] = None) -> dict:
        """Fire at the preferred replica; after hedge_s with no answer,
        race a second replica on a FRESH connection (the pooled conns
        stay owned by the main path). First non-error response wins.
        `deadline_s` bounds the WHOLE hedged wait (else self.timeout)."""
        import queue

        req = self._traced(req)

        budget = self.timeout if deadline_s is None else deadline_s
        overall = time.monotonic() + budget

        with self._lock:
            now = time.monotonic()
            # snapshot the address map: attempt() runs on hedge
            # threads while add_node/remove_node may mutate it
            addrs = dict(self.addrs)
            healthy = [n for n in sorted(addrs)
                       if self._down.get(n, 0) <= now]
            pool = healthy or sorted(addrs)
            first = self._preferred if self._preferred in pool \
                else pool[0]
            down = dict(self._down)
        others = [n for n in sorted(addrs) if n != first]
        others = sorted(others, key=lambda n: down.get(n, 0) > now)
        results: queue.Queue = queue.Queue()

        def attempt(node):
            if netfault.armed() and netfault.act(
                    addrs[node], can_dup=False) == netfault.DROP:
                results.put(None)
                return
            try:
                sock = socket.create_connection(
                    addrs[node], timeout=min(2.0, budget))
                sock.settimeout(budget)
                try:
                    wire.write_frame(sock, wire.dumps(req))
                    results.put(wire.loads(wire.read_frame(sock)))
                finally:
                    sock.close()
            except (OSError, EOFError, wire.WireError):
                results.put(None)

        threads = [threading.Thread(target=attempt, args=(first,),
                                    daemon=True)]
        threads[0].start()
        failures = 0
        try:
            got = results.get(timeout=min(hedge_s,
                                          overall - time.monotonic()))
            if got is not None:
                return got  # ok or a real application error: surface it
            failures += 1   # connection-level failure
        except (queue.Empty, ValueError):
            pass  # ValueError: the budget is already gone
        # primary is slow/dead: hedge to a backup replica — unless the
        # budget is spent, in which case a raced connection + query
        # could never be consumed anyway
        if time.monotonic() < overall:
            threads.append(threading.Thread(target=attempt,
                                            args=(others[0],),
                                            daemon=True))
            threads[1].start()
        while time.monotonic() < overall and failures < len(threads):
            try:
                got = results.get(timeout=max(
                    0.01, overall - time.monotonic()))
            except queue.Empty:
                break
            if got is not None:
                return got
            failures += 1
        # both raced attempts failed to CONNECT: fall back to the
        # routed retry path, within whatever budget remains
        return self.request(req, deadline_s=None if deadline_s is None
                            else max(0.0, overall - time.monotonic()))

    def _call(self, op: str, kw: dict,
              deadline_ms: Optional[int]) -> Any:
        """One deadline-bounded op RPC: `deadline_ms` rides the wire
        (the serving leader inherits the remaining budget, reqctx
        PROPAGATION_SKEW_S wide) AND bounds the routed-retry loop
        here to the same clock — an expired client must not keep a
        leader working on its behalf."""
        req = {"op": op, "kw": kw}
        deadline_s = None
        if deadline_ms is not None:
            req["deadline_ms"] = int(deadline_ms)
            deadline_s = deadline_ms / 1000.0
        return self._unwrap(self.request(req, deadline_s=deadline_s))

    def mutate(self, deadline_ms: Optional[int] = None, **kw) -> dict:
        return self._call("mutate", kw, deadline_ms)

    # dgo-style interactive txns: the group leader stages; commit
    # replicates (a leader change aborts open txns — retry)
    def txn_mutate(self, start_ts: int = 0,
                   deadline_ms: Optional[int] = None, **kw) -> dict:
        kw["commit_now"] = False
        if start_ts:
            kw["start_ts"] = start_ts
        return self._call("mutate", kw, deadline_ms)

    def txn_commit(self, start_ts: int, abort: bool = False) -> dict:
        return self._unwrap(self.request(
            {"op": "commit",
             "params": {"startTs": str(start_ts),
                        "abort": "true" if abort else "false"}}))

    def alter(self, schema_text: str = "",
              deadline_ms: Optional[int] = None, **kw) -> dict:
        kw["schema_text"] = schema_text
        return self._call("alter", kw, deadline_ms)

    def members(self) -> dict:
        return self._unwrap(self.request({"op": "members"}))

    def conf_change(self, action: str, node: int,
                    addr: Optional[tuple[str, int]] = None) -> dict:
        """Add/remove a raft group member (ref conn/raft_server.go
        JoinCluster; zero /removeNode). After an add, call add_node()
        so this client can reach the new member too."""
        req = {"op": "conf_change", "action": action, "node": node}
        if addr is not None:
            req["addr"] = tuple(addr)
        return self._unwrap(self.request(req))

    def add_node(self, node: int, addr: tuple[str, int]):
        with self._lock:
            self.addrs[node] = tuple(addr)

    def remove_node(self, node: int):
        with self._lock:
            self.addrs.pop(node, None)
            sock = self._conns.pop(node, None)
            if self._preferred == node:
                self._preferred = None
        if sock is not None:
            sock.close()

    def subscribe(self, pred: str, offset: int = 0,
                  wait_ms: int = 0, limit: int = 256,
                  sub_id: str = "") -> dict:
        """One CDC poll: entries with offset > `offset` from whichever
        node answers (any replica serves the same stream — offsets are
        deterministic across the group). Raises cdc.OffsetTruncated
        when the resume offset predates the serving node's log floor;
        the caller re-syncs (snapshot read at resync_ts, resubscribe
        from offset_for_ts(resync_ts)).

        Use a DEDICATED ClusterClient per subscriber: a long-poll
        parks the pooled per-node connection for up to wait_ms, and
        the per-node mutex would stall other requests sharing it."""
        resp = self.request(
            {"op": "subscribe", "pred": pred, "offset": int(offset),
             "wait_ms": int(wait_ms), "limit": int(limit),
             "id": sub_id},
            deadline_s=wait_ms / 1000.0 + max(5.0, self.timeout))
        if not resp.get("ok") and resp.get("truncated"):
            from dgraph_tpu_torch.cdc.changelog import OffsetTruncated
            t = resp["truncated"]
            # the wire payload carries the server-derived resync ts
            # explicitly (same camelCase key as the HTTP 410 surface);
            # legacy servers sent only the floor — derive as before
            raise OffsetTruncated(
                t["pred"], int(offset), t["floor"],
                resync_ts=t.get("resyncTs", t.get("resync_ts")))
        return self._unwrap(resp)

    def hello(self, protocol_version: Optional[int] = None) -> dict:
        """Version negotiation (storage/versions.py): returns the
        serving node's {protocol, format, build, negotiated} where
        `negotiated` = min(server's protocol, ours)."""
        from dgraph_tpu_torch.storage.versions import PROTOCOL_VERSION
        pv = PROTOCOL_VERSION if protocol_version is None \
            else int(protocol_version)
        return self._unwrap(self.request(
            {"op": "hello", "protocol_version": pv}))

    def status(self, node: Optional[int] = None) -> dict:
        if node is not None:
            resp = self._rpc_once(node, {"op": "status"})
            if resp is None:
                raise ConnectionError(f"node {node} unreachable")
            return resp["result"]
        return self._unwrap(self.request({"op": "status"}))

    # -------------------------------------------------------- zero surface

    def read_ts(self) -> int:
        """Zero's current max timestamp WITHOUT bumping it — the
        grant for watermark-bounded follower reads (the snapshot at
        this ts is final: every future commit_ts exceeds it)."""
        return self._unwrap(self.request({"op": "read_ts"}))

    def assign_ts(self, n: int = 1) -> int:
        return self._unwrap(self.request(
            {"op": "assign_ts", "args": (n,)}))

    def assign_uids(self, n: int) -> int:
        return self._unwrap(self.request(
            {"op": "assign_uids", "args": (n,)}))

    def commit(self, start_ts: int, keys: list[int]) -> int:
        return self._unwrap(self.request(
            {"op": "commit", "args": (start_ts, list(keys))}))

    def tablet(self, pred: str, group: int) -> int:
        return self._unwrap(self.request(
            {"op": "tablet", "args": (pred, group)}))

    @staticmethod
    def _unwrap(resp: dict) -> Any:
        if not resp.get("ok"):
            # a serving node's typed cancellation/deadline marker
            # (service.py _client_loop) re-raises TYPED here, so the
            # HTTP/gRPC edges map it to 408/499/429 instead of 500
            cls = _ABORT_TYPES.get(resp.get("aborted", ""))
            if cls is not None:
                raise cls(resp.get("error", resp["aborted"]))
            if resp.get("misrouted"):
                # the tablet moved after this client's map was
                # fetched: typed + retryable — RoutedCluster refreshes
                # the map and re-routes instead of surfacing a 500
                from dgraph_tpu_torch.cluster.errors import TabletMisrouted
                m = resp["misrouted"]
                raise TabletMisrouted(m.get("pred", "?"),
                                      m.get("group"),
                                      resp.get("error", ""))
            if resp.get("stale"):
                # a follower read outran this replica's applied
                # watermark: typed + retryable — the router re-issues
                # the read at another replica (the leader always
                # qualifies) instead of surfacing an error
                from dgraph_tpu_torch.cluster.errors import StaleRead
                s = resp["stale"]
                raise StaleRead(int(s.get("readTs", 0)),
                                int(s.get("watermark", -1)),
                                resp.get("error", ""))
            if resp.get("fenced"):
                # the whole cluster refuses client writes (replication
                # standby / fenced old primary) — typed and NOT
                # retryable here: the client must re-point at the
                # active primary
                from dgraph_tpu_torch.cluster.errors import WriteFenced
                raise WriteFenced(resp["fenced"].get("phase", ""),
                                  resp.get("error", ""))
            if resp.get("deadline_expired"):
                # the caller's budget died in the routing loop (e.g.
                # an election outlasted it) — same typed outcome as a
                # server-side expiry
                raise DeadlineExceeded(
                    "deadline exceeded while routing: "
                    + resp.get("error", "rpc failed"))
            raise RuntimeError(resp.get("error", "rpc failed"))
        return resp["result"]
