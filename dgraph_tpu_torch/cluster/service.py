"""Networked Raft services: Alpha groups and the Zero quorum as real
processes on real sockets.

The reference runs every shard as a Raft group inside an Alpha process
(worker/draft.go Run loop pumping etcd raft Ready) and the cluster
coordinator as its own Raft quorum inside Zero (dgraph/cmd/zero/
raft.go:619, zero.go:410). This module is that tier: `RaftServer` owns
a RaftNode, a TcpTransport (cluster/transport.py), a wall-clock tick
loop and a client RPC listener; `AlphaServer` replicates a GraphDB
through it (leader executes, expanded records replicate — the
worker/mutation.go:537 MutateOverNetwork shape), `ZeroServer`
replicates the coordinator state machine (ts/uid leases + conflict
oracle — zero/assign.go, zero/oracle.go).

Client protocol: wire-framed request/response dicts. Writes must land
on the leader; a follower answers {"ok": False, "leader": id} and the
client re-dials (ref conn/pool.go + dgo's leader routing).

Port of `dgraph_tpu/cluster/service.py`: a copy, its imports pointed at
this package.
An `AlphaServer` builds its engine from `db_kw` (`prefer_device=False`
by default, as in the reference), so `device` rides there: None (the
default) is the card, raising without one; a snapshot restore and a
rebuild from the event stream land on the same device. A `ZeroServer`
holds no engine and touches no card. An alpha's wire `stats` op also
carries `kernelLaunches`, the process's kernel launch counts.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Optional

from dgraph_tpu_torch import wire
from dgraph_tpu_torch.cluster.raft import (
    FOLLOWER, GOODBYE, LEADER, Msg, RaftNode, VOTE_REQ,
)
from dgraph_tpu_torch.cluster.errors import (
    StaleRead, TabletMisrouted, WriteFenced,
)
from dgraph_tpu_torch.cluster.transport import TcpTransport
from dgraph_tpu_torch.utils import failpoint, metrics, netfault, tracing
from dgraph_tpu_torch.utils.logger import log
from dgraph_tpu_torch.utils.reqctx import (
    PROPAGATION_SKEW_S, DeadlineExceeded, Overloaded, RequestAborted,
    RequestContext,
)

import socket


class RaftServer:
    """A Raft replica process: tick thread + transport + client RPC.

    Subclasses define the replicated state machine:
      - sm_apply(origin, payload) -> Any   (every committed entry)
      - sm_snapshot() -> Any / sm_restore(Any)
      - handle_request(req) -> dict        (client RPC dispatch)
    """

    def __init__(self, node_id: int,
                 raft_peers: dict[int, tuple[str, int]],
                 client_addr: tuple[str, int],
                 storage=None, tick_s: float = 0.05,
                 election_ticks: int = 10,
                 snapshot_every: int = 2048,
                 debug_port: int = 0,
                 debug_host: str = "127.0.0.1",
                 learner: bool = False,
                 learner_ids=()):
        self.id = node_id
        # conf-changed membership persisted in raft storage wins over
        # the CLI's --raft-peers on restart (ref zero/raft.go member
        # state living in Zero's raft group)
        saved = storage.load_members() if storage is not None else None
        self._removed_ids: set[int] = set()
        # non-voting members (raft learners): replicated to, never
        # counted toward any quorum, never campaigning — the read
        # scale-out tier (ref etcd learner members / the reference's
        # StreamMembership non-voting replicas)
        self.learner_ids: set[int] = set()
        if saved and isinstance(saved, dict) and "members" in saved:
            self.members = {int(k): tuple(v)
                            for k, v in saved["members"].items()}
            self._removed_ids = {int(x)
                                 for x in saved.get("removed", ())}
            self.learner_ids = {int(x)
                                for x in saved.get("learners", ())}
        elif saved:
            self.members = {int(k): tuple(v) for k, v in saved.items()}
        else:
            self.members = dict(raft_peers)
        if learner:
            self.learner_ids.add(node_id)
        # membership learned at join time (zero's connect reply marks
        # learner members) — persisted membership still wins above
        if not saved:
            self.learner_ids |= {int(x) for x in learner_ids}
        if node_id not in self.members and node_id in raft_peers \
                and node_id not in self._removed_ids:
            self.members[node_id] = raft_peers[node_id]
        voters = [m for m in self.members
                  if m not in self.learner_ids]
        self.node = RaftNode(node_id, voters,
                             storage=storage,
                             election_ticks=election_ticks,
                             learner=node_id in self.learner_ids)
        for lid in sorted(self.learner_ids):
            self.node.add_learner(lid)
        self.lock = threading.RLock()
        self.applied_cv = threading.Condition(self.lock)
        self.tick_s = tick_s
        self.snapshot_every = snapshot_every
        self._applied_since_snap = 0
        self._mark_seq = itertools.count(1)
        self._acked: dict[tuple, Any] = {}
        # wall clock on purpose: the epoch must differ across process
        # RESTARTS (monotonic restarts near zero every boot)
        self.epoch = int(time.time() * 1000) % (1 << 40)  # dglint: disable=DG06
        self._stop = threading.Event()
        # peer -> monotonic time a Raft message last arrived from it:
        # the operator-visible "is this peer partitioned from me" age
        # (surfaced in status/health/debug stats and tools/dgtop.py —
        # a partition is otherwise invisible from the outside until
        # something times out)
        self._last_heard: dict[int, float] = {}
        transport_peers = dict(self.members)
        if node_id in raft_peers:  # own listen addr always from CLI
            transport_peers[node_id] = raft_peers[node_id]
        self.transport = TcpTransport(node_id, transport_peers,
                                      self._on_msg)

        self._client_listener = socket.socket(
            socket.AF_INET, socket.SOCK_STREAM)
        self._client_listener.setsockopt(
            socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._client_listener.bind(client_addr)
        self._client_listener.listen(64)
        self.client_addr = self._client_listener.getsockname()

        # trace identity: one pid lane per node in the merged Perfetto
        # view. Subclasses set a descriptive name (alpha-g1-n2) before
        # calling super().__init__; the process-global default covers
        # one-node-per-process deployments, the per-thread binding in
        # the serving loops covers in-process multi-node harnesses.
        self.node_name = getattr(self, "node_name", f"node-{node_id}")
        tracing.set_node(self.node_name)

        self._threads = [
            threading.Thread(target=self._tick_loop, daemon=True,
                             name=f"raft-tick-{node_id}"),
            threading.Thread(target=self._client_accept_loop, daemon=True,
                             name=f"client-accept-{node_id}"),
        ]

        # read-only debug/observability HTTP listener (stats, request
        # ring, Prometheus text, trace slices, sampling profiler) —
        # the reference wires its pprof/expvar mux onto every node
        # (x/metrics.go); collectors (tools/dgtop.py, tools/dgbench.py)
        # scrape it without speaking the framed wire protocol. 0 = off.
        self.debug_httpd = None
        if debug_port:
            from dgraph_tpu_torch.server.debug_http import serve_debug
            self.debug_httpd, dport = serve_debug(
                stats_fn=self.debug_stats_payload,
                health_fn=self.health_payload,
                node_name=self.node_name,
                host=debug_host, port=debug_port)
            log.info("debug_http_listening", node=self.node_name,
                     port=dport)

        # restore-from-disk snapshot surfaces on the first ready();
        # only then open the floodgates (transport.start) so no inbound
        # message races construction
        with self.lock:
            out = self._drain_ready()
        self.transport.start()
        self._send_all(out)
        for t in self._threads:
            t.start()

    # ----------------------------------------------------------- raft side

    def _on_msg(self, msg):
        goodbye = None
        with self.lock:
            if self._stop.is_set():
                return
            self._last_heard[msg.frm] = time.monotonic()
            if msg.type == GOODBYE:
                # a member told us we were conf-removed (backstop for
                # a lost farewell append): go quiet
                if not self.node.removed:
                    log.info("raft_removed_notice", node=self.id,
                             frm=msg.frm)
                self.node.removed = True
                self.node.role = FOLLOWER
                self.node.leader_id = None
                return
            if msg.frm in self._removed_ids:
                # TOMBSTONED ex-members must not disturb the cluster
                # (their election timeouts would otherwise inflate
                # terms forever); tell them why so they go quiet.
                # Unknown ids are NOT dropped — an in-progress joiner
                # whose conf-add this node hasn't applied yet may need
                # to campaign to heal a leader loss (vote quorum stays
                # safe: only conf members' votes count).
                if msg.type == VOTE_REQ:
                    goodbye = Msg(GOODBYE, self.id, msg.frm,
                                  self.node.term)
            else:
                self.node.step(msg)
            out = self._drain_ready()
        if goodbye is not None:
            out.append(goodbye)
        self._send_all(out)

    def _tick_loop(self):
        tracing.set_thread_node(self.node_name)
        while not self._stop.wait(self.tick_s):
            with self.lock:
                self.node.tick()
                out = self._drain_ready()
            self._send_all(out)

    def _drain_ready(self) -> list:
        """Apply committed state under the lock; RETURN outbound msgs.
        Sends happen outside the lock — a TCP dial to a dead peer can
        block ~1s, and stalling ticks that long would trip healthy
        followers' election timers."""
        r = self.node.ready()
        if r.soft_state != getattr(self, "_soft_state", None):
            self._soft_state = r.soft_state
            log.info("raft_soft_state", node=self.id,
                     role=r.soft_state[0], leader=r.soft_state[1],
                     term=self.node.term)
        if r.snapshot is not None:
            # chaos seam: an armed `snapshot.install` failpoint delays
            # or fails the install — an error action models the apply
            # path dying mid-install (the node wedges, like a crash)
            failpoint.fire("snapshot.install")
            log.info("raft_snapshot_restore", node=self.id,
                     index=r.snapshot[0])
            data = r.snapshot[2]
            if isinstance(data, dict) and "__members__" in data:
                # snapshots carry membership so a late joiner that
                # never saw the conf entries still learns the cluster
                self._install_members(data["__members__"],
                                      data.get("__removed__", ()),
                                      data.get("__learners__", ()))
                data = data["app"]
            self.sm_restore(data)
            self._acked.clear()
        if r.committed:
            # one span per committed batch (not per entry): the
            # request thread's propose_and_wait drains here, so a
            # traced write's apply cost shows inside its trace; tick-
            # thread applies self-root under this node's lane
            with tracing.span("raft.apply", n=len(r.committed)):
                for e in r.committed:
                    if e.data is None:
                        continue
                    mark, origin, payload = e.data
                    if isinstance(payload, tuple) and payload \
                            and payload[0] == "__conf__":
                        result = self._apply_conf(*payload[1:])
                    else:
                        result = self.sm_apply(origin, payload)
                    self._acked[mark] = result
                    self._applied_since_snap += 1
                    self.applied_cv.notify_all()
            # committed-applied distance AFTER an apply batch (not on
            # every message: the gauge write is off the heartbeat hot
            # path this way) — the watchdog's raft_apply_lag rule and
            # Prometheus both read it
            metrics.set_gauge(
                "dgraph_raft_apply_lag",
                max(0, self.node.commit_index
                    - self.node.applied_index),
                labels={"node": getattr(self, "node_name",
                                        f"node-{self.id}")})
        if self._applied_since_snap >= self.snapshot_every:
            self._applied_since_snap = 0
            self.node.take_snapshot(
                {"__members__": dict(self.members),
                 "__removed__": sorted(self._removed_ids),
                 "__learners__": sorted(self.learner_ids),
                 "app": self.sm_snapshot()})
        return r.msgs

    # ------------------------------------------------------- membership
    # Single-change-at-a-time conf changes applied at commit (the etcd
    # model; ref conn/raft_server.go JoinCluster + zero /removeNode).

    def _install_members(self, members: dict, removed=(), learners=()):
        members = {int(k): tuple(v) for k, v in members.items()}
        for nid, addr in members.items():
            if nid != self.id:
                self.transport.peers[nid] = addr
        self.members = members
        self._removed_ids = {int(x) for x in removed}
        self.learner_ids = {int(x) for x in learners
                            if int(x) in members}
        for nid in list(self.node.peers) + sorted(self.node.learners):
            if nid not in members:
                self.node.remove_peer(nid)
        for nid in members:
            if nid == self.id:
                continue
            if nid in self.learner_ids:
                self.node.add_learner(nid)
            else:
                self.node.add_peer(nid)
        if self.id not in members:
            self.node.remove_peer(self.id)
        elif self.id in self.learner_ids:
            self.node.add_learner(self.id)
        self._save_members()

    def _apply_conf(self, action: str, nid: int, addr=None) -> bool:
        nid = int(nid)
        if action == "add":
            if addr is None:
                return False
            self.members[nid] = tuple(addr)
            self.learner_ids.discard(nid)  # promotion keeps progress
            if nid != self.id:
                self.transport.peers[nid] = tuple(addr)
            self.node.add_peer(nid)
        elif action == "add_learner":
            # non-voting join: the learner receives the replicated log
            # (and this very conf entry) but never joins any quorum
            if addr is None:
                return False
            self.members[nid] = tuple(addr)
            self.learner_ids.add(nid)
            if nid != self.id:
                self.transport.peers[nid] = tuple(addr)
            self.node.add_learner(nid)
        elif action == "remove":
            self.members.pop(nid, None)
            if nid != self.id and self.node.role == LEADER \
                    and nid in self.node.peers:
                # farewell append BEFORE forgetting the peer: it
                # carries the commit index covering this removal, so
                # the leaving node applies it, learns it was removed,
                # and goes quiet instead of campaigning forever
                # (review finding: the commit otherwise never reaches
                # it). The transport keeps its address so the queued
                # message can still be delivered; a lost farewell is
                # backstopped by GOODBYE notices.
                self.node._send_append(nid)
            self.node.remove_peer(nid)
            self.learner_ids.discard(nid)
        else:
            return False
        if action in ("add", "add_learner"):
            self._removed_ids.discard(nid)
        else:
            self._removed_ids.add(nid)
        log.info("raft_conf_change", node=self.id, action=action,
                 member=nid, members=sorted(self.members))
        self._save_members()
        return True

    def _save_members(self):
        if self.node.storage is not None:
            self.node.storage.save_members(
                {"members": dict(self.members),
                 "removed": sorted(self._removed_ids),
                 "learners": sorted(self.learner_ids)})

    def _conf_in_flight(self) -> bool:
        """One membership change at a time (raft §4.1 single-server
        rule): reject a new one while any conf entry is unapplied."""
        for e in self.node.log:
            if e.index <= self.node.applied_index or e.data is None:
                continue
            payload = e.data[2]
            if isinstance(payload, tuple) and payload \
                    and payload[0] == "__conf__":
                return True
        return False

    def handle_conf_request(self, req: dict) -> dict:
        """Shared cluster ops every RaftServer kind answers; returns
        None for ops the subclass should handle."""
        op = req.get("op")
        if op == "members":
            with self.lock:
                return {"ok": True, "result": {
                    "members": {str(k): list(v)
                                for k, v in self.members.items()},
                    "learners": sorted(self.learner_ids),
                    "removed": self.node.removed}}
        if op == "fault":
            # live control of THIS node's outbound fault table
            # (utils/netfault.py) — the wire half of the chaos plane's
            # control surface (POST /debug/fault is the HTTP half).
            # tools/dgchaos.py arms partitions/delay storms with it
            # and heals them with {"action": "clear"}.
            try:
                return {"ok": True,
                        "result": netfault.handle_control(req)}
            except (ValueError, KeyError, TypeError) as e:
                return {"ok": False,
                        "error": f"bad fault control: {e}"}
        if op == "traces":
            # node-local trace slice (the wire analogue of HTTP
            # /debug/traces?trace_id=): tools/trace_merge.py stitches
            # slices from every node into one Perfetto timeline. The
            # node filter matters for in-process multi-node harnesses,
            # where several logical nodes share one span ring.
            want = req.get("trace")
            spans = tracing.spans_for(want) if want \
                else tracing.recent_spans(int(req.get("limit", 512)))
            spans = [s for s in spans
                     if s.get("node") == self.node_name]
            return {"ok": True, "result": {"node": self.node_name,
                                           "spans": spans}}
        if op == "pprof":
            # on-demand wall-clock sampling profile of THIS process
            # (the wire analogue of HTTP /debug/pprof, same payload):
            # seconds=/hz=/format= ride the request dict. Blocks the
            # serving connection for the window — by contract — but
            # never the raft lock: sampling is lock-free.
            from dgraph_tpu_torch.utils import pprof
            return {"ok": True, "result": pprof.handle_params(
                {k: req[k] for k in ("seconds", "hz", "format")
                 if k in req},
                node=self.node_name)}
        if op == "metrics_text":
            # Prometheus text exposition over the cluster wire, for
            # collectors (tools/dgbench.py) scraping nodes that run
            # without the HTTP debug listener
            from dgraph_tpu_torch.utils import metrics
            return {"ok": True,
                    "result": {"node": self.node_name,
                               "text": metrics.render_prometheus()}}
        if op == "alerts":
            # the alerting plane over the cluster wire (the analogue
            # of HTTP /debug/alerts): rule catalog + firing set +
            # recent transitions, with operator controls riding the
            # request dict (ack=<series>, silence=<series> +
            # silence_s=<ttl>). Zero's override adds the cluster-wide
            # aggregation of piggybacked alpha alerts.
            from dgraph_tpu_torch.utils import watchdog
            if req.get("ack"):
                return {"ok": True, "result": {
                    "acked": watchdog.ack(str(req["ack"]))}}
            if req.get("silence"):
                watchdog.silence(str(req["silence"]),
                                 float(req.get("silence_s", 3600.0)))
                return {"ok": True, "result": {"silenced": True}}
            out = watchdog.alerts_payload()
            out["node"] = self.node_name
            out.update(self._alerts_extra())
            return {"ok": True, "result": out}
        if op == "incidents":
            # the flight recorder's bundle ring (the analogue of HTTP
            # /debug/incidents): manifests, or one full bundle by id
            from dgraph_tpu_torch.utils import watchdog
            try:
                out = watchdog.incidents_payload(
                    limit=int(req.get("limit", 16)),
                    bundle=req.get("id"))
            except KeyError as e:
                return {"ok": False, "error": str(e)}
            out["node"] = self.node_name
            return {"ok": True, "result": out}
        if op == "conf_change":
            action = req.get("action")
            nid = int(req.get("node", 0))
            addr = req.get("addr")
            if action not in ("add", "add_learner", "remove") \
                    or not nid:
                return {"ok": False, "error": "bad conf_change"}
            if action in ("add", "add_learner") and not addr:
                return {"ok": False, "error": f"{action} needs addr"}
            def gate():
                # checked under the SAME lock as the propose: two
                # racing conf_change RPCs must not both slip past the
                # single-change-in-flight rule (review finding)
                if self.node.role != LEADER:
                    raise NotLeader(self.node.leader_id)
                if self._conf_in_flight():
                    return "another membership change is in flight"
                return None

            ok, result = self.propose_and_wait(
                ("__conf__", action, nid,
                 tuple(addr) if addr else None), gate=gate)
            if not ok:
                return {"ok": False, "error":
                        result if isinstance(result, str)
                        else "conf change not committed"}
            if not result:
                return {"ok": False,
                        "error": "conf change not committed"}
            with self.lock:
                members = {str(k): list(v)
                           for k, v in self.members.items()}
            return {"ok": True, "result": {"members": members}}
        return None

    def _send_all(self, msgs: list):
        for m in msgs:
            self.transport.send(m)

    def propose_and_wait(self, payload: Any,
                         timeout: float = 5.0,
                         gate=None) -> tuple[bool, Any]:
        """Propose on this node (must be leader); wait until the entry
        applies locally. -> (committed, apply result). `gate`, when
        given, runs under the SAME lock as the propose and aborts it
        by returning an error string — check-then-propose sequences
        (the one-conf-change-in-flight rule) need that atomicity."""
        mark = (self.id, self.epoch, next(self._mark_seq))
        with self.lock:
            if gate is not None:
                err = gate()
                if err:
                    return False, err
            if not self.node.propose((mark, (self.id, self.epoch),
                                      payload)):
                return False, None
            out = self._drain_ready()
        self._send_all(out)
        with self.lock:
            deadline = time.monotonic() + timeout
            while mark not in self._acked:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    return False, None
                self.applied_cv.wait(remaining)
            return True, self._acked[mark]

    def is_leader(self) -> bool:
        with self.lock:
            return self.node.role == LEADER

    def leader_hint(self) -> Optional[int]:
        with self.lock:
            return self.node.leader_id

    # --------------------------------------------------------- client side

    def _client_accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._client_listener.accept()
            except OSError:
                return
            threading.Thread(target=self._client_loop, args=(conn,),
                             daemon=True).start()

    def _serve_traced(self, req: dict) -> dict:
        """handle_request under the caller's trace: a request carrying
        `trace_id` (attached by ClusterClient from its bound context)
        gets an `rpc.recv` span on THIS node, parented to the caller's
        rpc.send span across the wire — the hop every federated task,
        follower redirect and 2PC fan-out shows up as in the merged
        timeline."""
        tid = req.get("trace_id", "")
        if not tid or not tracing.enabled():
            return self.handle_request(req)
        with tracing.bind(tid, req.get("parent_span", ""),
                          node=self.node_name), \
                tracing.span("rpc.recv", op=str(req.get("op", ""))):
            return self.handle_request(req)

    # client-facing ops whose FAILURES the wire edge records into the
    # request log. Only ops whose SUCCESSES the engine also records
    # (db.py _query_metrics / mutate) belong here: an op with
    # failure-only recording would build an all-bad SLO series that
    # fires during a fault and then starves below min_volume, holding
    # the alert forever. Inner 2PC/task failures surface as query/
    # mutate failures at the coordinator anyway. Routing signals —
    # NotLeader/misroute/stale/fenced — are retries, not failures,
    # and must not burn SLO budget.
    _SLO_OPS = frozenset({"query", "mutate"})

    def _log_wire_failure(self, req: dict, exc: BaseException,
                          t0: float) -> None:
        op = str(req.get("op", ""))
        if op not in self._SLO_OPS:
            return
        from dgraph_tpu_torch.utils import reqlog
        reqlog.record(
            op, trace_id=str(req.get("trace_id", "")),
            latency_ms=(time.perf_counter() - t0) * 1e3,
            outcome=reqlog.outcome_of(exc),
            tenant=str(req.get("tenant") or ""))

    def _client_loop(self, conn: socket.socket):
        tracing.set_thread_node(self.node_name)
        try:
            while not self._stop.is_set():
                req = wire.loads(wire.read_frame(conn))
                t0 = time.perf_counter()
                try:
                    resp = self._serve_traced(req)
                except NotLeader as e:
                    resp = {"ok": False, "error": "not leader",
                            "leader": e.leader}
                except TabletMisrouted as e:
                    # typed on the wire: the router refreshes its
                    # tablet map and re-routes (bounded retries) —
                    # a post-flip stale route is never a bare 500
                    resp = {"ok": False, "error": str(e),
                            "misrouted": {"pred": e.pred,
                                          "group": e.group}}
                except StaleRead as e:
                    # typed + retryable: the router re-runs the read
                    # on another replica of the group (the leader
                    # always qualifies) — bounded staleness must
                    # degrade to a retry, never to an old snapshot
                    resp = {"ok": False, "error": str(e),
                            "stale": {"readTs": e.read_ts,
                                      "watermark": e.watermark},
                            "retryable": True}
                except WriteFenced as e:
                    # typed: the client must re-point at the active
                    # primary, not retry here (async replication —
                    # standbys and fenced old primaries refuse ALL
                    # client writes)
                    resp = {"ok": False, "error": str(e),
                            "fenced": {"phase": e.phase}}
                except RequestAborted as e:
                    # cancellation/deadline crosses the wire TYPED:
                    # ClusterClient._unwrap maps `aborted` back to the
                    # reqctx exception (so the HTTP/gRPC edges answer
                    # 408/499/429, not 500) and `retryable` marks
                    # deadline/overload for jittered-backoff loops
                    self._log_wire_failure(req, e, t0)
                    resp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}",
                            "aborted": type(e).__name__,
                            "retryable": isinstance(
                                e, (DeadlineExceeded, Overloaded))}
                except Exception as e:  # surface, don't kill the conn
                    self._log_wire_failure(req, e, t0)
                    resp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                wire.write_frame(conn, wire.dumps(resp))
        except (EOFError, OSError, wire.WireError):
            pass
        finally:
            conn.close()

    # ----------------------------------------------------------- lifecycle

    def peer_ages(self) -> dict:
        """Seconds since a Raft message last arrived from each peer
        (None = never heard since boot). A healthy link ticks at the
        heartbeat cadence, so an age of several election timeouts IS a
        partition, visible from the outside — the judge dgtop and the
        chaos report read."""
        with self.lock:
            now = time.monotonic()
            return {str(p): (round(now - self._last_heard[p], 3)
                             if p in self._last_heard else None)
                    for p in self.members if p != self.id}

    def _alerts_extra(self) -> dict:
        """Extra fields the `alerts` wire op carries for this node
        kind (zero adds the cluster-wide aggregation)."""
        return {}

    def watchdog_signals(self) -> dict:
        """Stall-watchdog signals this node kind contributes to each
        evaluator tick (utils/watchdog.py register_signals): raft
        apply lag and the quietest peer's silence age. Subclasses
        extend."""
        with self.lock:
            lag = max(0, self.node.commit_index
                      - self.node.applied_index)
        out = {"raft_apply_lag": float(lag)}
        ages = [a for a in self.peer_ages().values()
                if a is not None]
        if ages:
            out["raft_peer_silent_s"] = max(ages)
        return out

    def attach_watchdog(self, wd) -> None:
        """Register this node's signal/context providers on the
        process watchdog (cli.py `node` calls it after boot)."""
        wd.register_signals(self.node_name, self.watchdog_signals)

    def debug_stats_payload(self) -> dict:
        """What this node kind contributes to /debug/stats on the
        debug HTTP listener (counters/gauges/histograms are appended
        by the listener itself). Subclasses override."""
        from dgraph_tpu_torch.utils import watchdog
        return {"node": self.node_name,
                "netfault": netfault.rules(),
                "lastHeard": self.peer_ages(),
                "alerts": watchdog.firing_summary()}

    def health_payload(self) -> dict:
        with self.lock:
            out = {"id": self.id, "role": self.node.role,
                   "leader": self.node.leader_id,
                   "term": self.node.term,
                   "learner": self.node.learner}
        out["lastHeard"] = self.peer_ages()
        return out

    def close(self):
        self._stop.set()
        self.transport.close()
        if self.debug_httpd is not None:
            self.debug_httpd.shutdown()
            self.debug_httpd.server_close()  # shutdown() only stops
            # the loop; close the bound socket too or every closed
            # node leaks one fd + one port
        try:
            self._client_listener.close()
        except OSError:
            pass
        with self.lock:
            self.applied_cv.notify_all()

    def serve_forever(self):
        try:
            while not self._stop.wait(0.5):
                pass
        except KeyboardInterrupt:
            self.close()

    # ----------------------------------------------- state machine (abstract)

    def sm_apply(self, origin, payload) -> Any:
        raise NotImplementedError

    def sm_snapshot(self) -> Any:
        raise NotImplementedError

    def sm_restore(self, snap: Any) -> None:
        raise NotImplementedError

    def handle_request(self, req: dict) -> dict:
        raise NotImplementedError


class NotLeader(Exception):
    def __init__(self, leader: Optional[int]):
        super().__init__("not leader")
        self.leader = leader


class AlphaServer(RaftServer):
    """A replicated GraphDB group member (the worker/draft.go role).

    Writes execute on the leader's engine — allocating ts/uids and
    producing expanded commit records via the on_record sink — then each
    record replicates through Raft; followers apply it verbatim
    (worker/mutation.go expand-then-propose shape). If quorum is lost
    mid-write the leader rebuilds its engine from the committed event
    stream so it never serves un-replicated state.
    """
    # dglint: guarded-by=db:atomic (the binding is REBOUND only by
    # the raft-apply path — sm_restore/_rebuild_from_events, under
    # RaftServer.lock — and the swap of the reference itself is
    # GIL-atomic; readers grab the binding once and tolerate serving
    # from either the pre- or post-restore engine, the same contract
    # a snapshot install gives the reference's workers)

    def __init__(self, node_id: int, raft_peers, client_addr,
                 storage=None, db_kw: Optional[dict] = None,
                 group: int = 1, replicas: int = 1,
                 zero_addrs: Optional[dict] = None,
                 snapshot: str = "", max_pending: int = 0,
                 learner: bool = False,
                 tenant_rate: float = 0.0,
                 tenant_burst: float = 0.0, **kw):
        from dgraph_tpu_torch.engine.db import GraphDB

        # admission control on the wire surface (the cluster analogue
        # of the HTTP edge's --max-pending): a bounded in-flight count
        # over the work-bearing ops; excess load sheds TYPED
        # (Overloaded -> `aborted` on the wire -> the caller's 429
        # class) instead of queueing unboundedly on the serving locks.
        # 0 = unbounded.
        self.max_pending = max_pending
        self._admission = threading.Lock()
        self._inflight = 0
        # per-tenant QoS layered UNDER max_pending: one hot tenant
        # exhausts its own token bucket and degrades to typed 429s
        # while the shared in-flight budget stays available to the
        # rest (server/qos.py)
        self.qos = None
        if tenant_rate > 0:
            from dgraph_tpu_torch.server.qos import TenantQos
            self.qos = TenantQos(rate=tenant_rate, burst=tenant_burst)
        # non-voting read replica (raft learner): never campaigns or
        # serves writes; joins its group via the add_learner conf
        # change and serves watermark-bounded follower reads
        self.learner = learner

        # group=0 + a zero quorum = elastic join (ref zero/zero.go:410
        # Connect): zero assigns this node to the least-replicated
        # group (or founds a new one), hands back the group's members,
        # and the node raft-joins them live
        self._join_members: dict = {}
        if group == 0:
            if not zero_addrs:
                raise ValueError("--group 0 (auto) needs --zero")
            from dgraph_tpu_torch.cluster.client import ClusterClient
            probe = ClusterClient(zero_addrs, timeout=30.0)
            try:
                my_raft = tuple(raft_peers[node_id])
                got = probe.request({
                    "op": "connect",
                    "args": (f"{my_raft[0]}:{my_raft[1]}", 0, 0,
                             my_raft, tuple(client_addr),
                             int(replicas), int(bool(learner)))},
                    deadline_s=60.0)
                if not got.get("ok"):
                    raise RuntimeError(
                        f"zero connect failed: {got.get('error')}")
                asg = got["result"]
            finally:
                probe.close()
            group = asg["group"]
            node_id = asg["id"]
            raft_peers = {int(i): tuple(m["raft"])
                          for i, m in asg["members"].items()}
            raft_peers[node_id] = my_raft
            # existing learners must not be mistaken for voters (a
            # candidate counting them in its quorum could never win)
            kw.setdefault("learner_ids", tuple(
                int(i) for i, m in asg["members"].items()
                if m.get("learner") and int(i) != node_id))
            # conf changes land on the group LEADER: learners never
            # lead, so they are not join targets
            self._join_members = {
                int(i): tuple(m["client"])
                for i, m in asg["members"].items()
                if int(i) != node_id and not m.get("learner")}

        self.group = group
        self._db_kw = dict(db_kw or {})
        self._db_kw.setdefault("prefer_device", False)
        # zero-issued global read timestamps are in flight here: lag
        # background folds so pinned readers rarely hit StaleSnapshot
        # (carried in _db_kw so sm_restore/_rebuild_from_events keep
        # it when they build a fresh engine)
        self._db_kw.setdefault("rollup_window", 512)
        self.db = GraphDB(**self._db_kw)
        # bulk-booted group: seed the engine from a `dgraph_tpu bulk
        # --reduce-shards` output BEFORE raft starts (ref handing
        # out/<i>/p to a group's alphas; every replica of the group
        # must boot from the same snapshot file)
        self._boot_snapshot = snapshot
        if snapshot:
            from dgraph_tpu_torch.storage.snapshot import load_snapshot
            load_snapshot(snapshot, self.db)
        # open interactive txns (dgo flow): leader-local by design —
        # the reference's txns are likewise coordinated with the group
        # leader and die on leader change (clients retry)
        self._txns: dict[int, Any] = {}
        self._txn_touched: dict[int, float] = {}
        # stage time of replicated cross-group fragments, for TTL-based
        # reconciliation against zero's decision registry
        self._xstage_touched: dict[int, float] = {}
        # negative txn_status cache: start_ts -> highest read_ts the
        # txn was verified UNDECIDED for. A txn undecided at check time
        # can only commit with a commit_ts issued after the check, so
        # any read_ts obtained before it stays clean — pinned reads and
        # federated tasks skip the zero RPC below that watermark.
        self._xstatus_clean: dict[int, int] = {}
        # live tablet-move plumbing (leader-local, deliberately NOT
        # replicated — both sides are rebuilt idempotently when a
        # leader dies): source-side cached export blobs served in
        # re-deliverable chunks, destination-side chunk staging
        # buffers assembled by move_install. pred -> dict.
        self._move_exports: dict[str, dict] = {}
        self._move_staging: dict[str, dict] = {}
        # last touches count reported to zero per tablet (the heat
        # report ships DELTAS); baseline-initialized on first sight so
        # a fresh leader's lifetime counter doesn't land as one spike.
        # dglint: guarded-by=_heat_sent:single-thread (only touched by
        # the one _report_sizes_loop daemon; the boot paths that could
        # each spawn it are mutually exclusive)
        self._heat_sent: dict[str, int] = {}
        # multi-group mode: a Zero quorum owns the tablet map and the
        # uid space; this alpha claims tablets, checks ownership before
        # every write, and leases uid blocks (ref worker/groups.go
        # BelongsTo + zero/assign.go lease blocks)
        self.zero = None
        if zero_addrs:
            from dgraph_tpu_torch.cluster.client import ClusterClient
            self.zero = ClusterClient(zero_addrs, timeout=10.0)
            self.db.coordinator.uid_lease_fn = self.zero.assign_uids
            # one GLOBAL timestamp order across every group (ref zero
            # AssignTimestampIds): cross-group snapshot reads become
            # comparable, at one zero RPC per allocation. The ts client
            # gets a deadline WELL below the election timeout: ts
            # allocation happens under the raft lock, and a stalled
            # zero must fail the write fast, not stall heartbeats until
            # our followers depose us.
            ts_budget = max(0.05,
                            kw.get("tick_s", 0.05) *
                            kw.get("election_ticks", 10) / 3)
            self._zero_ts = ClusterClient(zero_addrs, timeout=ts_budget)
            self.db.coordinator.ts_source_fn = self._zero_ts.assign_ts
            # ALL commit decisions flow through zero's oracle in
            # multi-group mode — one global conflict window, so
            # single-group and cross-group transactions see each
            # other (ref zero/oracle.go:326: every commit is zero's)
            self.db.coordinator.commit_source_fn = self._zero_ts.commit
        # committed event stream: authoritative rebuild source
        self._events: list[tuple] = []
        # serializes execute+propose so the log's record order matches
        # the leader engine's execution order (followers must apply
        # deltas in commit-ts order)
        self._write_lock = threading.Lock()
        # serializes ordered application of decided 2PC finalizes —
        # two concurrent drains could otherwise interleave commits out
        # of ts order (see _drain_finalizes)
        self._finalize_lock = threading.Lock()
        self.node_name = f"alpha-g{self.group}-n{node_id}"
        super().__init__(node_id, raft_peers, client_addr,
                         storage=storage, learner=learner, **kw)
        if self.learner and not self._join_members:
            if self.zero is None:
                raise ValueError(
                    "--learner needs --zero to discover the group's "
                    "voters for the add_learner conf change")
            # stay quiet until the group leader conf-adds us as a
            # learner and its first append arrives
            with self.lock:
                self.node.removed = True
            threading.Thread(target=self._join_as_learner, daemon=True,
                             name=f"learn-g{self.group}-{self.id}"
                             ).start()
        elif self._join_members:
            # stay quiet (no campaigning) until the group leader adds
            # us via conf change and its first append arrives — an
            # eager candidate here would inflate terms it can't win
            with self.lock:
                self.node.removed = True
            threading.Thread(target=self._join_group, daemon=True,
                             name=f"join-g{self.group}-{self.id}").start()
            threading.Thread(target=self._report_sizes_loop,
                             daemon=True,
                             name=f"sizes-{self.id}").start()
        elif self.zero is not None:
            # explicit group: register with zero in the background so
            # its membership registry (connect decisions, /state)
            # knows this member too
            threading.Thread(target=self._register_with_zero,
                             daemon=True,
                             name=f"register-{self.id}").start()
        if self.zero is not None and not self.learner:
            # watermark beacon: leaders relay zero's global max_ts
            # through the log so idle groups' replicas can still
            # cover fresh read grants (see _watermark_loop)
            threading.Thread(target=self._watermark_loop, daemon=True,
                             name=f"wm-g{self.group}-{self.id}"
                             ).start()

    def _join_group(self):
        """Ask the group's current members to conf-change us in (ref
        conn/raft_server.go JoinCluster), retrying through elections."""
        from dgraph_tpu_torch.cluster.client import ClusterClient
        cl = ClusterClient(self._join_members, timeout=30.0)
        try:
            my_raft = self.transport.peers.get(self.id) or \
                self.transport.addr
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and not self._stop.is_set():
                with self.lock:
                    if not self.node.removed:
                        return  # the leader reached us: we're in
                try:
                    cl.conf_change(
                        "add_learner" if self.learner else "add",
                        self.id, tuple(my_raft))
                    return
                except RuntimeError as e:
                    if "in flight" not in str(e):
                        log.warning("join_retry", node=self.id,
                                    error=str(e))
                time.sleep(0.5)
        finally:
            cl.close()

    def _register_with_zero(self):
        my_raft = self.transport.peers.get(self.id) or self.transport.addr
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not self._stop.is_set():
            got = self.zero.request({
                "op": "connect",
                "args": (f"{my_raft[0]}:{my_raft[1]}", self.group,
                         self.id, tuple(my_raft),
                         tuple(self.client_addr), 1,
                         int(bool(self.learner)))})
            if got.get("ok") and self._claim_boot_tablets():
                break
            time.sleep(1.0)
        self._report_sizes_loop()

    def _join_as_learner(self):
        """Explicit-group learner boot: register with zero (so routers
        see this replica in cluster_state), discover the group's
        voters, and ask them to conf-add us as a NON-VOTING member —
        retrying through elections until the leader's first append
        proves we are in (ref etcd AddLearnerNode)."""
        from dgraph_tpu_torch.cluster.client import ClusterClient
        my_raft = self.transport.peers.get(self.id) or \
            self.transport.addr
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not self._stop.is_set():
            with self.lock:
                if not self.node.removed:
                    break  # the leader reached us: we're in
            try:
                self.zero.request({
                    "op": "connect",
                    "args": (f"{my_raft[0]}:{my_raft[1]}", self.group,
                             self.id, tuple(my_raft),
                             tuple(self.client_addr), 1, 1)})
                got = self.zero.request({"op": "cluster_state"})
                voters: dict[int, tuple] = {}
                if got.get("ok"):
                    for rec in got["result"]["alphas"].values():
                        if rec.get("group") == self.group \
                                and not rec.get("learner") \
                                and int(rec["id"]) != self.id:
                            nid = int(rec["id"])
                            voters[nid] = tuple(rec["client"])
                            # the learner boots knowing only its OWN
                            # raft addr: without the voters' addrs its
                            # APPEND_RESPs have nowhere to go, the
                            # leader never learns its progress, and
                            # catch-up deadlocks on the first rejected
                            # heartbeat
                            with self.lock:
                                raddr = tuple(rec["raft"])
                                self.members[nid] = raddr
                                self.transport.peers[nid] = raddr
                if voters:
                    cl = ClusterClient(voters, timeout=10.0)
                    try:
                        cl.conf_change("add_learner", self.id,
                                       tuple(my_raft))
                    except RuntimeError as e:
                        if "in flight" not in str(e):
                            log.warning("learner_join_retry",
                                        node=self.id, error=str(e))
                    finally:
                        cl.close()
            except Exception as e:  # noqa: BLE001 — keep retrying  # dglint: disable=DG07 (boot-time join loop; no request context exists yet)
                log.warning("learner_join_retry", node=self.id,
                            error=str(e))
            time.sleep(0.5)
        self._report_sizes_loop()

    def _claim_boot_tablets(self) -> bool:
        """Bulk-booted state: register every pre-loaded tablet with
        zero and push the snapshot's ts/uid watermarks so zero never
        leases below them (ref bulk/loader.go:88 zero-leased uids;
        zero.go ShouldServe claims).  False keeps the registration
        loop retrying — a silently missed watermark would let the
        first post-boot mutation lease uids that collide with bulk
        entities."""
        if not self._boot_snapshot:
            return True
        try:
            got = self.zero.request({"op": "bump_maxes", "args": (
                self.db.coordinator.max_assigned(),
                self.db.coordinator._next_uid)})
            if not got.get("ok"):
                return False
            for pred in sorted(self.db.tablets):
                if pred.startswith("dgraph."):
                    continue
                got = self.zero.request(
                    {"op": "tablet", "args": (pred, self.group)})
                if not got.get("ok"):
                    return False
                if got.get("result") != self.group:
                    log.warning("boot_tablet_conflict", pred=pred,
                                owner=got.get("result"),
                                group=self.group)
            return True
        except Exception as e:  # noqa: BLE001 — zero unreachable:  # dglint: disable=DG07 (boot-time registration loop; no request context exists yet)
            # retry from the registration loop
            log.warning("boot_claim_retry", error=str(e))
            return False

    def _report_sizes_loop(self, interval_s: float = 0.0):
        """Leader-only periodic tablet size + HEAT reports to zero —
        the rebalancer's weights (ref zero/tablet.go:180 sizes from
        membership updates). Heat = query-path touch DELTA since this
        node's last report (storage/tabstats.py `touches`); zero folds
        the deltas into a per-tablet EWMA. The first sighting of a
        tablet reports delta 0 (baseline), so a fresh leader's
        lifetime counter never lands as one giant spike."""
        if interval_s <= 0:
            # default 30s like the reference's membership updates;
            # DGRAPH_TPU_HEAT_INTERVAL_S speeds smokes/benches up
            import os as _os
            try:
                interval_s = float(_os.environ.get(
                    "DGRAPH_TPU_HEAT_INTERVAL_S", "") or 30.0)
            except ValueError:
                interval_s = 30.0
        while not self._stop.wait(interval_s):
            with self.lock:
                if self.node.role != LEADER:
                    continue
                # snapshot refs ONLY under the raft lock —
                # approx_bytes walks every posting list (O(store)) and
                # holding the lock that long would stall heartbeats
                # into an election (see the ts_budget note above)
                tabs = [(pred, tab)
                        for pred, tab in self.db.tablets.items()
                        if not pred.startswith("dgraph.")]
            live = {pred for pred, _ in tabs}
            for pred in list(self._heat_sent):
                if pred not in live:
                    # dropped/moved-away tablet: clear the baseline —
                    # a tablet moving BACK restarts touches at 0, and
                    # a stale high baseline would report delta 0
                    # through an entire query storm
                    del self._heat_sent[pred]
            batch = {}
            seen = {}
            for pred, tab in tabs:
                try:
                    nbytes = tab.approx_bytes()
                except RuntimeError:
                    continue  # mutated mid-scan; next cycle gets it
                t = int(getattr(tab, "touches", 0))
                last = self._heat_sent.get(pred)
                if last is None or t < last:
                    delta = 0  # first sight / counter restarted
                else:
                    delta = t - last
                batch[pred] = (nbytes, delta)
                seen[pred] = t
            # piggyback this node's FIRING alerts on the existing
            # report (zero's leader keeps a cluster-wide aggregation
            # for {"op":"alerts"} / dgalert --cluster): rides the
            # request dict, stripped zero-side before the propose —
            # alert state is observability, never replicated state
            from dgraph_tpu_torch.utils import watchdog
            firing = watchdog.firing_summary()
            # ALWAYS send, even with an empty batch and no alerts:
            # the report doubles as this node's status heartbeat —
            # zero's report_silent watchdog times the gap, which is
            # the only node-down signal that still works at
            # replicas=1 (no raft peers to go silent). Zero skips
            # the raft propose for empty batches, so an idle node
            # costs one tiny RPC per interval, not log growth.
            try:
                # ONE batched request, not one RPC per tablet
                got = self.zero.request({"op": "tablet_heat",
                                         "args": (batch,),
                                         "alerts": firing,
                                         "alerts_node":
                                         self.node_name})
                if got.get("ok"):
                    # advance baselines only on a DELIVERED report: a
                    # report lost to a zero election must not eat its
                    # window's touch deltas (the EWMA would cool the
                    # hottest tablet exactly when it matters)
                    self._heat_sent.update(seen)
            except Exception:  # noqa: BLE001 — best-effort report  # dglint: disable=DG07 (daemon loop; no request context flows here)
                pass

    # -------------------------------------------------------- state machine

    def sm_apply(self, origin, rec) -> int:
        if rec == ("noop",):
            return 0  # read-barrier marker, no state change
        if isinstance(rec, tuple) and rec and rec[0] == "wm":
            # watermark beacon (leader relays zero's max_ts through
            # the log): fast-forward on EVERY replica including the
            # proposing leader — soft state only, so it's not an
            # _events record and a rebuild simply waits for the next
            # beacon. Log order makes this safe: every local commit
            # with ts <= beacon was proposed before it (the beacon is
            # proposed under _write_lock), so by the time a follower
            # applies the beacon those commits have applied here too.
            self.db.fast_forward_ts(int(rec[1]))
            return 0
        self._events.append(("rec", rec))
        if origin == (self.id, self.epoch):
            return 0  # leader pre-applied while executing the txn
        ts = self.db.apply_record(rec)
        if ts:
            self.db.fast_forward_ts(ts)
        return 0

    def sm_snapshot(self):
        from dgraph_tpu_torch.storage.snapshot import dump_state
        snap = wire.dumps(dump_state(self.db))
        self._events = [("snap", snap)]
        return snap

    def sm_restore(self, snap: bytes):
        from dgraph_tpu_torch.engine.db import GraphDB
        from dgraph_tpu_torch.storage.snapshot import restore_state
        self._events = [("snap", snap)]
        db = restore_state(wire.loads_compat(snap),
                           GraphDB(**self._db_kw))
        db.coordinator.uid_lease_fn = self.db.coordinator.uid_lease_fn
        db.coordinator.ts_source_fn = self.db.coordinator.ts_source_fn
        self.db = db
        self._drop_stale_txns()

    def _rebuild_from_events(self):
        """Quorum lost mid-write: discard un-replicated local state
        (the deposed-leader-drops-uncommitted-tail analogue)."""
        from dgraph_tpu_torch.engine.db import GraphDB
        from dgraph_tpu_torch.storage.snapshot import restore_state
        self.epoch += 1  # own-origin records must re-apply from now on
        db = GraphDB(**self._db_kw)
        db.coordinator.uid_lease_fn = self.db.coordinator.uid_lease_fn
        db.coordinator.ts_source_fn = self.db.coordinator.ts_source_fn
        for kind, payload in self._events:
            if kind == "snap":
                db = restore_state(wire.loads_compat(payload), db)
            else:
                # apply a COPY: the rebuilt engine's tablets must not
                # alias the event-stream payloads (rollup mutates
                # tablet state in place)
                ts = db.apply_record(wire.loads(wire.dumps(payload)))
                if ts:
                    db.fast_forward_ts(ts)
        self.db = db
        self._drop_stale_txns()

    def _drop_stale_txns(self):
        """The engine object was just replaced (rebuild/snapshot
        restore): open txn handles alias the OLD engine and oracle —
        committing one against the new engine would stage against a
        dead coordinator. Drop them all; clients see 'no open txn' and
        retry, exactly the leader-change contract. Caller holds
        self.lock."""
        self._txns.clear()
        self._txn_touched.clear()

    def _evict_idle_txns(self, ttl_s: float = 300.0):
        """Abort open txns idle past the TTL (ref --abort_older_than).
        Caller holds self.lock."""
        now = time.monotonic()
        for ts, t in list(self._txn_touched.items()):
            if now - t > ttl_s:
                txn = self._txns.pop(ts, None)
                self._txn_touched.pop(ts, None)
                if txn is not None:
                    self.db.discard(txn)

    def _reconcile_pending(self, upto_ts: int | None = None,
                           evict_older_s: float | None = None) -> bool:
        """Resolve replicated cross-group stages against zero's
        decision registry (ref posting/oracle.go ProcessDelta: alphas
        learn commit decisions they missed). With upto_ts, every
        DECIDED txn whose commit could be <= upto_ts must be applied
        before a pinned read at upto_ts (undecided txns are safe: zero
        would assign them a commit_ts issued after upto_ts). With
        evict_older_s, undecided stages older than the TTL are aborted
        THROUGH zero (abort_txn records the decision, so a slow
        coordinator can't later commit what we evicted).

        Returns False when some relevant pending could NOT be verified
        or a decided one could not be applied — pinned readers must
        then fail closed (retryable) rather than serve a snapshot that
        may be missing an acknowledged commit (a parked local commit
        returns success to its client; serving around it would break
        read-your-writes)."""
        if self.zero is None:
            return True
        now = time.monotonic()
        with self.lock:
            pend = [ts for ts in self.db.pending_txns
                    if upto_ts is None or ts < upto_ts]
            # a stage inherited via raft replay/snapshot (the staging
            # leader died) starts its TTL clock at first sight here
            ages = {st: now - self._xstage_touched.setdefault(st, now)
                    for st in pend}
            if not self.db.pending_txns:
                self._xstatus_clean.clear()
        decided: list[tuple[int, int]] = []  # (commit_ts, start_ts)
        ok = True
        for st in pend:
            if upto_ts is None and evict_older_s is not None \
                    and ages[st] <= evict_older_s:
                continue  # young and nobody is waiting: no zero RPC
            if upto_ts is not None:
                with self.lock:
                    clean = self._xstatus_clean.get(st, 0)
                if clean >= upto_ts:
                    continue  # verified undecided for this snapshot

            try:
                got = self.zero.request({"op": "txn_status",
                                         "args": (st,)})
                if not got.get("ok"):
                    ok = False
                    continue
                status = got["result"]
                if not status["decided"]:
                    if upto_ts is not None:
                        with self.lock:
                            self._xstatus_clean[st] = max(
                                self._xstatus_clean.get(st, 0),
                                upto_ts)
                    if evict_older_s is None or \
                            ages[st] <= evict_older_s:
                        continue
                    if st < status.get("floor", 0):
                        # zero trimmed this ts range: the decision is
                        # unknowable, and recording an abort could
                        # contradict a commit another group applied.
                        # Keep the stage pending (operator-visible)
                        # rather than guess.
                        ok = False
                        continue
                    final = self.zero.request(
                        {"op": "abort_txn", "args": (st,)})
                    if not final.get("ok"):
                        ok = False
                        continue
                    status = {"commit_ts": final["result"]}
                decided.append((int(status["commit_ts"]), st))
            except RequestAborted:
                # a cancelled/expired caller must not be absorbed
                # into "retry next pass"
                raise
            except Exception:  # noqa: BLE001 — next pass retries
                ok = False
                continue
        if decided and not self._drain_finalizes():
            ok = False
        return ok

    def _drain_finalizes(self, hint: tuple[int, int] | None = None
                         ) -> bool:
        """Public entry: takes the write lock first (global lock order
        is _write_lock -> _finalize_lock -> lock; the local-commit path
        drains while already holding _write_lock, so acquiring
        _finalize_lock before _write_lock anywhere would invert)."""
        with self._write_lock:
            return self._drain_finalizes_locked(hint)

    def _drain_finalizes_locked(self, hint: tuple[int, int] | None = None
                                ) -> bool:
        """Apply every DECIDED pending 2PC fragment in COMMIT-TS
        order, atomically with respect to other drains. Caller holds
        _write_lock.

        Racing coordinators' finalize RPCs (or a reconcile racing one)
        can otherwise deliver commits out of ts order; an out-of-order
        overlay delta both mis-serializes single-value overwrite
        expansion and breaks every ts-sorted overlay consumer — the
        split-bank chaos run lost a committed credit to exactly this
        (a later-committed transfer's read missed it, then overwrote).

        The status GATHER happens under the same lock as the apply
        loop: a drain that only knew about a later commit could
        otherwise apply it while an earlier-decided stage (whose
        status fetch failed elsewhere) is still pending.  If ANY
        pending stage's status cannot be fetched, the whole drain
        aborts — applying around an unknown would gamble on its order.
        Ordering is sufficient: zero decides serially, so a stage
        still undecided during the gather will get a commit_ts above
        everything already decided.  `hint` = (commit_ts, start_ts)
        already known by the caller (saves one RPC)."""
        with self._finalize_lock:
            with self.lock:
                pend = sorted(self.db.pending_txns)
            decided: list[tuple[int, int]] = []
            for st in pend:
                if hint is not None and st == hint[1]:
                    decided.append((int(hint[0]), st))
                    continue
                try:
                    got = self.zero.request({"op": "txn_status",
                                             "args": (st,)})
                except RequestAborted:
                    raise
                except Exception:  # noqa: BLE001
                    return False
                if not got.get("ok"):
                    return False
                if got["result"]["decided"]:
                    decided.append(
                        (int(got["result"]["commit_ts"]), st))
            for c, st in sorted(decided):
                try:
                    # chaos seam: delay/fail a decided fragment's
                    # finalize apply — a FailpointError is swallowed
                    # below like any transient failure (the reconcile
                    # machinery retries next pass, which is exactly
                    # the recovery path under test). An armed sleep
                    # stalling the drain under _finalize_lock is the
                    # POINT of the seam: finalize ordering pressure is
                    # what the nemesis schedules exist to create.
                    failpoint.fire("txn.xfinalize")  # dglint: disable=DG04 (chaos seam: the armed delay must stall this drain; inert cost is one dict check)
                    self._replicate_record_locked(("xfinalize", st, c))
                except RequestAborted:
                    raise
                except Exception:  # noqa: BLE001 — retried next pass
                    return False
                with self.lock:
                    self._xstage_touched.pop(st, None)
                    self._xstatus_clean.pop(st, None)
            return True

    def _drop_txn_handle(self, txn) -> None:
        """Forget (and, if still open, abort) a leader-local txn
        handle — the oracle must never keep a start_ts pinned for a
        txn its client cannot reach anymore."""
        with self.lock:
            self._txns.pop(txn.start_ts, None)
            self._txn_touched.pop(txn.start_ts, None)
            if not txn.done:
                self.db.discard(txn)

    def _drain_before_local_apply(self, commit_ts: int) -> bool:
        """Between a local commit's ts RESERVATION and its APPLY, land
        every already-decided pending 2PC fragment (all necessarily
        below our ts). Caller holds _write_lock.

        Retries patiently on gather failure: zero answered the
        reservation RPC moments ago, so unreachability here is a
        transient blip — and applying around an unknown-order pending
        risks the out-of-order hard error at apply
        (storage/tablet.py Tablet.apply) when that fragment finalizes.
        Returns False on sustained failure; the caller must then PARK
        the reserved commit as a pending fragment instead of applying
        (applying anyway would deadlock the group: the lower-ts
        fragment could never apply NOR fold past the local delta)."""
        with self.lock:
            if not self.db.pending_txns:
                return True
        deadline = time.monotonic() + 30.0
        while not self._drain_finalizes_locked():
            if time.monotonic() >= deadline or self._stop.is_set():
                log.warning("commit_undrained_pendings",
                            commit_ts=commit_ts)
                return False
            time.sleep(0.05)
        return True

    def _applied_watermark(self) -> int:
        """Highest commit timestamp this replica has applied (the
        coordinator's max_assigned is fast-forwarded by every applied
        record, so on a follower/learner it IS the applied watermark).
        Caller holds self.lock."""
        return self.db.coordinator.max_assigned()

    def _await_watermark(self, read_ts: int, ctx=None,
                         wait_s: float = 2.0):
        """Watermark-bounded follower read, the wait half: block until
        this replica's applied watermark covers `read_ts`, bounded by
        `wait_s` (and half the caller's remaining deadline, so the
        typed retry still reaches it). On timeout raise the typed
        StaleRead — the router retries on another replica rather than
        ever serving a snapshot older than the granted timestamp."""
        if ctx is not None:
            rem = ctx.remaining_ms()
            if rem is not None:
                wait_s = min(wait_s, max(0.0, rem / 1000.0) / 2)
        with self.lock:
            deadline = time.monotonic() + wait_s
            while True:
                wm = self._applied_watermark()
                if wm >= read_ts:
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    metrics.inc_counter("dgraph_stale_reads_total")
                    raise StaleRead(read_ts, wm)
                # capped wait: the watermark can advance without an
                # applied_cv notify (leader-local allocations)
                self.applied_cv.wait(min(remaining, 0.05))

    def _watermark_loop(self, interval_s: float = 0.0):
        """Leader-only watermark beacon (ref zero's MaxAssigned in the
        oracle delta stream): zero's max_ts is GLOBAL, so a group
        whose last local commit predates another group's can never
        cover a fresh read grant on its own — every watermark-bounded
        read there would burn its full wait and fail over. The leader
        periodically reads zero's current max_ts (the non-bumping
        read_ts op) and, when it is ahead of the local watermark,
        replicates it as a ("wm", ts) record so every replica —
        learners included — fast-forwards.

        Safety: proposed under _write_lock, so any LOCAL commit with
        ts <= beacon is already in the log ahead of it; cross-group
        stages decided-but-unfinalized are skipped here (pending_txns
        gate) and independently blocked at read time by the
        pending-txn check in the follower-read path."""
        if interval_s <= 0:
            import os as _os
            try:
                interval_s = float(_os.environ.get(
                    "DGRAPH_TPU_WM_INTERVAL_S", "") or 0.2)
            except ValueError:
                interval_s = 0.2
        while not self._stop.wait(interval_s):
            with self.lock:
                if self.node.role != LEADER:
                    continue
                wm = self._applied_watermark()
            try:
                got = self.zero.request({"op": "read_ts"})
                if not got.get("ok"):
                    continue
                t = int(got["result"])
            except Exception:  # noqa: BLE001 — zero blip: next tick  # dglint: disable=DG07 (daemon loop; no request context flows here)
                continue
            if t <= wm:
                continue  # idle or already covered: no log traffic
            with self._write_lock:
                with self.lock:
                    # _write_lock freezes pending_txns (stages and
                    # local commits both mutate it under that lock),
                    # so these checks stay true through the propose
                    skip = (self.node.role != LEADER
                            or self._stop.is_set()
                            or bool(self.db.pending_txns)
                            or t <= self._applied_watermark())
                if skip:
                    continue
                try:
                    # outside self.lock like _replicate_record_locked:
                    # propose_and_wait sends + waits on applied_cv
                    self.propose_and_wait(("wm", t))
                except Exception:  # noqa: BLE001 — quorum blip  # dglint: disable=DG07 (daemon loop; no request context flows here)
                    continue

    def _read_barrier(self):
        """Linearizable-read barrier for pinned reads (raft §8): a
        freshly elected leader may hold committed-but-unapplied entries
        from the previous term, and cannot even KNOW the old commit
        index until an entry of its own term commits. Committing one
        no-op round-trip guarantees everything acknowledged before this
        read is applied here."""
        with self.lock:
            if self.node.role != LEADER:
                raise NotLeader(self.node.leader_id)
        # ALWAYS a quorum round-trip: a partitioned ex-leader that
        # still believes it leads cannot commit this no-op, so it
        # fails here instead of serving a stale snapshot (read-index
        # semantics; a local caught-up check is not enough)
        ok, _ = self.propose_and_wait(("noop",))
        if not ok:
            raise RuntimeError("read barrier failed (no quorum)")

    # --------------------------------------------------------------- writes

    def _check_ownership(self, preds, subjects=None):
        """Multi-group mode: every touched predicate must be served by
        THIS group per Zero's map; unclaimed predicates are claimed,
        FENCED tablets (the move's short `fenced` phase — reads never
        fence) reject writes retryably (ref zero.go ShouldServe +
        oracle's tablet checks at commit). A predicate owned elsewhere
        raises the TYPED TabletMisrouted so a router holding a
        pre-flip map refreshes and re-routes instead of surfacing 500.

        `subjects` — (pred, subject_uid) pairs of the write — lets a
        hash-range SPLIT predicate verify per-row ownership: each
        subject must hash into a shard this group serves
        (cluster/shard.py). Without subjects a split predicate rejects
        the write outright: only the router's per-shard 2PC path
        carries resolved uids. Caller holds _write_lock, so a
        concurrent export (which also takes it) serializes against
        in-flight writes."""
        if self.zero is None:
            return
        tmap = self.zero.request({"op": "tablet_map"})
        if not tmap.get("ok"):
            raise RuntimeError("zero unreachable; cannot verify "
                               "tablet ownership")
        if tmap["result"].get("fence"):
            # cluster-wide client-write fence (async replication):
            # this cluster is a standby — or the fenced old primary
            # after a promotion. Replication applies never come here
            # (move_apply/repl_install replicate records directly).
            raise WriteFenced(tmap["result"].get("repl_phase", ""))
        tablets = tmap["result"]["tablets"]
        moving = tmap["result"]["moving"]
        splits = tmap["result"].get("splits", {})
        subs_by_pred: dict[str, list[int]] = {}
        for p, u in subjects or ():
            subs_by_pred.setdefault(p, []).append(int(u))
        for p in preds:
            if p == "*" or p.startswith("dgraph."):
                continue
            if p in moving:
                raise RuntimeError(
                    f"tablet {p!r} is being moved; retry shortly")
            if p in splits:
                from dgraph_tpu_torch.cluster.shard import owner_for_uid
                subs = subs_by_pred.get(p)
                if subs is None:
                    raise TabletMisrouted(
                        p, None,
                        f"tablet {p!r} is split across groups; route "
                        "writes per subject through the cluster router")
                for u in subs:
                    owner = owner_for_uid(splits[p], u)
                    if owner != self.group:
                        raise TabletMisrouted(
                            p, owner,
                            f"subject {u:#x} of split tablet {p!r} "
                            f"belongs to group {owner}; refresh the "
                            "tablet map and re-route")
                continue
            owner = tablets.get(p)
            if owner is None:
                got = self.zero.tablet(p, self.group)
                if got != self.group:
                    raise TabletMisrouted(
                        p, got if got > 0 else None,
                        f"tablet {p!r} belongs to group {got}; "
                        "refresh the tablet map and re-route")
            elif owner != self.group:
                raise TabletMisrouted(
                    p, owner,
                    f"tablet {p!r} belongs to group {owner}; "
                    "refresh the tablet map and re-route")

    def _capture_and_replicate(self, fn) -> Any:
        """Run `fn(db)` on the leader with the record sink attached,
        then replicate every captured record; quorum loss rolls the
        engine back from the committed event stream. Caller holds
        _write_lock."""
        with self.lock:
            if self.node.role != LEADER:
                raise NotLeader(self.node.leader_id)
            captured: list = []
            prev = self.db.on_record
            self.db.on_record = captured.append
            try:
                result = fn(self.db)
            finally:
                self.db.on_record = prev
        for rec in captured:
            ok, _ = self.propose_and_wait(rec)
            if not ok:
                with self.lock:
                    self._rebuild_from_events()
                raise RuntimeError(
                    "write not replicated (no quorum)")
        return result

    def _replicate_write(self, fn, preds=()) -> Any:
        with self._write_lock:
            self._check_ownership(preds)
            return self._capture_and_replicate(fn)

    @staticmethod
    def _mutation_preds(kw: dict) -> set:
        from dgraph_tpu_torch.server.acl import nquad_predicates
        preds = set(nquad_predicates(
            kw.get("set_nquads", ""), kw.get("del_nquads", ""),
            kw.get("set_json"), kw.get("delete_json")))
        return {p.lstrip("~") for p in preds}

    def _replicate_record(self, rec) -> None:
        """Apply a pre-built engine record on the leader and replicate
        it (tablet import/drop — records that don't come from a txn
        sink). The leader applies a deep COPY: the log/_events keep the
        original payload, and later in-place tablet mutations (rollup
        folds) must never rewrite replicated history."""
        with self._write_lock:
            self._replicate_record_locked(rec)

    def _replicate_record_locked(self, rec) -> None:
        """_replicate_record body for callers already holding
        _write_lock (the finalize drain, which also runs from the
        local-commit path under the commit's own _write_lock)."""
        with self.lock:
            if self.node.role != LEADER:
                raise NotLeader(self.node.leader_id)
            ts = self.db.apply_record(wire.loads(wire.dumps(rec)))
            if ts:
                self.db.fast_forward_ts(ts)
        ok, _ = self.propose_and_wait(rec)
        if not ok:
            with self.lock:
                self._rebuild_from_events()
            raise RuntimeError("record not replicated (no quorum)")

    @staticmethod
    def _req_ctx(req: dict):
        """RequestContext a coordinator propagated on the wire
        (deadline_ms = its remaining budget): this worker inherits the
        budget widened by a small skew allowance, so the coordinator
        times out first and the worker's abort is the backstop (ref
        worker RPCs inheriting the query context)."""
        ms = req.get("deadline_ms")
        tenant = str(req.get("tenant") or "")
        if ms is None:
            if req.get("trace_id") or tenant:
                # no deadline, but the caller IS tracing (or carries a
                # tenant tag for reqlog/QoS attribution): keep the
                # context joined through the engine's bind_request
                return RequestContext.background(
                    trace_id=req.get("trace_id", ""),
                    parent_span=req.get("parent_span", ""),
                    tenant=tenant)
            return None
        return RequestContext.from_deadline_ms(
            ms, trace_id=req.get("trace_id", ""),
            skew_s=PROPAGATION_SKEW_S,
            parent_span=req.get("parent_span", ""),
            tenant=tenant)

    def _run_task(self, req: dict, read_ts: int):
        """Dispatch one federated task kind against the local tablet.
        Caller holds _write_lock + lock with leadership verified."""
        kind = req["kind"]
        if kind == "schema_state":
            return self.db.schema.describe_all()
        tab = self.db.tablets.get(req["pred"])
        if tab is None:
            return None
        uids = req.get("uids")
        rev = bool(req.get("reverse"))
        if kind == "edges":
            get = tab.get_reverse_uids if rev else tab.get_dst_uids
            return [get(int(u), read_ts) for u in uids.tolist()]
        if kind == "postings":
            return [tab.get_postings(int(u), read_ts)
                    for u in uids.tolist()]
        if kind == "expand":
            return tab.expand_frontier(uids, read_ts, rev)
        if kind == "src_uids":
            return tab.src_uids(read_ts)
        if kind == "dst_uids":
            return tab.dst_uids(read_ts)
        if kind == "index":
            return [tab.index_uids(bytes(t), read_ts)
                    for t in req["tokens"]]
        if kind == "counts":
            if rev:
                return [len(tab.get_reverse_uids(int(u), read_ts))
                        for u in uids.tolist()]
            return [tab.count_of(int(u), read_ts)
                    for u in uids.tolist()]
        if kind == "count_table":
            # the proxy's dirty() is False (the overlay never leaves
            # this group), so this table must be MVCC-exact at read_ts
            # — not the base-only fast table the local path splits
            # against its own overlay
            import numpy as _np
            srcs = tab.src_uids(read_ts)
            cnts = _np.asarray(
                [tab.count_of(int(u), read_ts) for u in srcs.tolist()],
                _np.int64)
            return (srcs, cnts)
        if kind == "facets":
            return [tab.get_facets(int(s), int(d), read_ts)
                    for s, d in req["pairs"]]
        if kind == "sort_key_pairs":
            return tab.sort_key_pairs()
        raise ValueError(f"unknown task kind {kind!r}")

    # ----------------------------------------------------------------- RPC

    # work-bearing ops that consume engine/leader time — including
    # cross-group 2PC STAGING (a shed xstage is safe: the coordinator
    # aborts at zero and clears staged fragments, topology.py
    # _mutate_multigroup). admin, stats and xfinalize are never shed:
    # finalize carries an already-DECIDED transaction, and shedding it
    # would stall that decision behind the very overload it relieves
    _ADMITTED_OPS = ("query", "mutate", "task", "xstage")

    def handle_request(self, req: dict) -> dict:
        if req.get("op") in self._ADMITTED_OPS:
            self._admit_tenant(req)
        if not self.max_pending \
                or req.get("op") not in self._ADMITTED_OPS:
            return self._handle_admitted(req)
        from dgraph_tpu_torch.utils import metrics
        with self._admission:
            if self._inflight >= self.max_pending:
                metrics.inc_counter("dgraph_queries_shed_total")
                raise Overloaded(
                    f"node {self.node_name} is overloaded: "
                    f"{self._inflight} requests in flight "
                    f"(max_pending={self.max_pending}); retry with "
                    "jittered backoff")
            self._inflight += 1
            metrics.set_gauge("dgraph_pending_queries", self._inflight)
        try:
            return self._handle_admitted(req)
        finally:
            with self._admission:
                self._inflight -= 1
                metrics.set_gauge("dgraph_pending_queries",
                                  self._inflight)

    def _admit_tenant(self, req: dict) -> None:
        """Per-tenant token-bucket admission, layered UNDER the shared
        max_pending plane: a tenant that exhausts its own budget sheds
        TYPED (Overloaded -> the caller's 429 class) while other
        tenants keep their full rate. Commits/finalizes are never
        shed here — they ride ops outside _ADMITTED_OPS."""
        qos = getattr(self, "qos", None)  # absent on bare test shells
        if qos is None:
            return
        tenant = str(req.get("tenant") or "default")
        if qos.admit(tenant):
            return
        from dgraph_tpu_torch.utils import metrics
        metrics.inc_counter("dgraph_tenant_shed_total",
                            labels={"tenant": tenant})
        raise Overloaded(
            f"tenant {tenant!r} exceeded its admission rate on "
            f"{self.node_name}; retry with jittered backoff")

    def _misroute_guard_query(self, q: str, variables) -> None:
        """A query naming a tablet this group MOVED AWAY must fail
        TYPED (TabletMisrouted), never silently return empty rows —
        the read-parity hazard of a client racing a cutover with a
        stale routing map. Zero-cost until this node has actually
        moved a tablet out (moved_out empty); a malformed query falls
        through to the engine's own parser error.

        Predicates reached only via expand() never appear in the
        query text or in query_predicates, so this screen cannot see
        them; that half of the window is closed by the executor-level
        ownership hook at expansion time
        (query/executor.py Executor._expand_ownership_guard), which
        raises the same typed TabletMisrouted when expand()
        materializes a moved or split predicate."""
        if self.zero is None or (not self.db.moved_out
                                 and not self.db.split_partial):
            return
        suspects = set(self.db.moved_out) | self.db.split_partial
        if not any(p in q for p in suspects):
            # a referenced predicate appears literally in the query
            # text, so the substring screen keeps the guard O(names)
            # on the hot path instead of re-parsing every query
            # forever once any tablet has ever moved away
            return
        try:
            from dgraph_tpu_torch.gql import parse
            from dgraph_tpu_torch.server.acl import query_predicates
            preds = {p.lstrip("~")
                     for p in query_predicates(parse(q, variables))}
        except Exception:  # noqa: BLE001 — the engine owns the error  # dglint: disable=DG07 (parse errors surface identically from db.query below)
            return
        for p in preds:
            if p in self.db.moved_out and p not in self.db.tablets:
                raise TabletMisrouted(p, self.db.moved_out[p])
            if p in self.db.split_partial:
                # this member holds only a hash range: a whole-
                # predicate read here would be silently partial —
                # the router re-fetches the map and federates
                raise TabletMisrouted(
                    p, None,
                    f"tablet {p!r} is split across groups; refresh "
                    "the tablet map and fan out per sub-tablet")

    def _handle_admitted(self, req: dict) -> dict:
        conf = self.handle_conf_request(req)
        if conf is not None:
            return conf
        op = req.get("op")
        if op == "query":
            self._misroute_guard_query(req["q"], req.get("vars"))
            # any replica serves best-effort snapshot reads
            # (edgraph/server.go:760); under the lock because the
            # apply/restore threads mutate and rebind self.db.
            # read_ts (a zero-issued GLOBAL timestamp) pins the MVCC
            # snapshot for cross-group scatter reads — leader-only,
            # since the leader applies its commits synchronously so a
            # read at T sees exactly the commits with ts <= T.
            read_ts = int(req.get("read_ts", 0)) or None
            ctx = self._req_ctx(req)
            if read_ts is not None and req.get("be"):
                # watermark-bounded follower read (ANY replica,
                # learners included): pinned at a zero-granted
                # read_ts, served only once the local applied
                # watermark covers it — a lagging replica degrades to
                # a typed retry-elsewhere, never to a snapshot older
                # than the granted timestamp. No quorum barrier: the
                # watermark wait plays its role for a ts that was
                # granted BEFORE the read (raft applies records in
                # commit-ts order, so watermark >= read_ts means every
                # commit <= read_ts has applied here).
                self._await_watermark(read_ts, ctx)
                with self.lock:
                    if any(ts < read_ts
                           for ts in self.db.pending_txns):
                        # a decided-but-unfinalized 2PC fragment could
                        # hold a commit <= read_ts; only the leader's
                        # reconcile path can verify — fail over
                        raise StaleRead(read_ts,
                                        self._applied_watermark())
                    out = self.db.query(
                        req["q"], variables=req.get("vars"),
                        read_ts=read_ts, ctx=ctx)
                return {"ok": True, "result": out}
            if read_ts is not None:
                # pinned read: pay the quorum barrier FIRST — a deposed
                # leader cannot commit the no-op, so it can never serve
                # a stale pinned snapshot. The barrier runs OUTSIDE
                # _write_lock (it is a full network round-trip; holding
                # the lock across it would serialize every write behind
                # each pinned read). Then take _write_lock only around
                # the local query so no commit is mid-flight (applied
                # locally, not yet quorum-acked — reading that state
                # would be a dirty read if replication later rolls
                # back). A write that sneaks in between barrier and
                # lock is fully replicated by the time we read — still
                # a consistent snapshot at read_ts.
                self._read_barrier()
                # AFTER the barrier (so a just-elected leader has
                # applied its inherited log first): decided-but-
                # unapplied cross-group commits <= read_ts must land
                # before this snapshot is served; fail CLOSED when a
                # pending cannot be verified (it may hold a commit
                # already acknowledged to its client)
                if not self._reconcile_pending(upto_ts=read_ts):
                    raise RuntimeError(
                        "cannot verify pending transactions against "
                        "the decision registry; retry")
                with self._write_lock:
                    with self.lock:
                        if self.node.role != LEADER:
                            raise NotLeader(self.node.leader_id)
                        out = self.db.query(
                            req["q"], variables=req.get("vars"),
                            read_ts=read_ts, ctx=ctx)
                return {"ok": True, "result": out}
            with self.lock:
                out = self.db.query(req["q"], variables=req.get("vars"),
                                    ctx=ctx)
            return {"ok": True, "result": out}
        if op == "mutate":
            kw = dict(req["kw"])
            commit_now = kw.pop("commit_now", True)
            start_ts = kw.pop("start_ts", 0)
            # a coordinator-propagated deadline bounds the stage too,
            # not just reads — an expired client must not keep this
            # group's leader staging on its behalf
            ctx = self._req_ctx(req)
            preds = self._mutation_preds(kw) if self.zero else ()
            # commit-now mutations take the SAME stage-then-commit flow
            # as interactive txns: the commit handler drains decided
            # lower-ts 2PC fragments between ts reservation and apply,
            # so a commit-now write can never overtake a pending
            # cross-group finalize (ref worker/draft.go:435 — one Raft
            # log gives the reference this ordering for free)
            with self.lock:
                if self.node.role != LEADER:
                    raise NotLeader(self.node.leader_id)
                self._evict_idle_txns()
                if start_ts:
                    txn = self._txns.get(start_ts)
                    if txn is None:
                        raise KeyError(
                            f"no open txn at startTs={start_ts} "
                            "(leader changed?)")
                else:
                    txn = self.db.new_txn()
            if kw.get("query") and self.zero is not None:
                # an upsert stage READS at the txn's start_ts: pay the
                # same linearizable-read protocol as a pinned query
                # (barrier: a fresh leader applies inherited xstage
                # records first; reconcile: decided-but-unapplied
                # fragments <= start_ts land before the read) — or the
                # read-modify-write computes against a snapshot missing
                # a commit it logically follows and overwrites it (the
                # mixed commit-now/2PC bank run lost exactly such a
                # credit)
                try:
                    self._read_barrier()
                    if not self._reconcile_pending(
                            upto_ts=txn.start_ts):
                        raise RuntimeError(
                            "cannot verify pending transactions "
                            "against the decision registry; retry")
                except Exception:
                    if not start_ts:
                        self.db.discard(txn)
                    raise
            with self._write_lock:
                try:
                    self._check_ownership(preds)
                except Exception:
                    # a txn created HERE must not leak its start_ts in
                    # the oracle (a pinned _active entry freezes the
                    # rollup watermark forever); an existing open txn
                    # stays open — the client may retry after the move
                    if not start_ts:
                        with self.lock:
                            self.db.discard(txn)
                    raise
                with self.lock:
                    if self.node.role != LEADER:
                        if not start_ts:
                            self.db.discard(txn)
                        raise NotLeader(self.node.leader_id)
                    try:
                        out = self.db.mutate(txn, commit_now=False,
                                             ctx=ctx, **kw)
                    except Exception:
                        # a failed stage aborts the whole txn (fail
                        # fast, like the reference's aborted TxnContext)
                        self._txns.pop(txn.start_ts, None)
                        self._txn_touched.pop(txn.start_ts, None)
                        self.db.discard(txn)
                        raise
                    self._txns[txn.start_ts] = txn
                    self._txn_touched[txn.start_ts] = time.monotonic()
                    out.setdefault("extensions", {})["txn"] = {
                        "start_ts": txn.start_ts}
            if commit_now:
                try:
                    resp = self.handle_request(
                        {"op": "commit",
                         "params": {"startTs": str(txn.start_ts)}})
                except Exception:
                    self._drop_txn_handle(txn)
                    raise
                if not resp.get("ok"):
                    # the client of a commit-now mutation has no txn
                    # handle to retry or abort with: a failed nested
                    # commit must not leave the staged txn registered
                    # (it would pin the fold watermark until the TTL)
                    self._drop_txn_handle(txn)
                    return resp
                # keep the stage's payload (uids map for blank nodes,
                # like a dgo CommitNow mutation) and graft the commit
                # extensions onto it
                out.setdefault("extensions", {}).update(
                    resp["result"].get("extensions", {}))
                return {"ok": True, "result": out}
            return {"ok": True, "result": out}
        if op == "commit":
            params = req.get("params", {})
            start_ts = int(params.get("startTs", 0))
            abort = params.get("abort", "false") == "true"
            with self._write_lock:
                with self.lock:
                    if self.node.role != LEADER:
                        raise NotLeader(self.node.leader_id)
                    txn = self._txns.get(start_ts)
                if txn is None:
                    raise KeyError(
                        f"no open txn at startTs={start_ts}")
                if abort:
                    with self.lock:
                        self._txns.pop(start_ts, None)
                        self._txn_touched.pop(start_ts, None)
                        self.db.discard(txn)
                    return {"ok": True, "result": {
                        "extensions": {"txn": {"start_ts": start_ts,
                                               "aborted": True}}}}
                # a tablet may have MOVED since the stage: committing
                # here would write to a group that no longer owns it.
                # Checked BEFORE removing the handle — on failure the
                # txn stays open (and its oracle entry alive) so the
                # advertised retry actually works
                self._check_ownership(
                    {pred for pred, _ in txn.staged},
                    subjects=[(p, op.src) for p, op in txn.staged])
                with self.lock:
                    self._txns.pop(start_ts, None)
                    self._txn_touched.pop(start_ts, None)
                try:
                    commit_ts = self.db.commit_reserve(txn)
                except Exception:
                    # reservation failure (conflict abort, zero ts RPC
                    # down) must release start_ts in the oracle
                    if not txn.done:
                        self.db.discard(txn)
                    raise
                # Every already-DECIDED cross-group fragment carries a
                # commit ts BELOW ours (zero assigns monotonically and
                # decides serially), so applying them first reproduces
                # log order; anything still undecided will land above
                # ours and may apply later
                if self._drain_before_local_apply(commit_ts):
                    commit_ts = self._capture_and_replicate(
                        lambda db: db.commit_apply(txn, commit_ts))
                else:
                    # zero went dark mid-commit with a pending whose
                    # order is unknowable. The decision IS recorded at
                    # zero, so park this commit as a pending fragment:
                    # the reconcile machinery applies everything in ts
                    # order once zero answers — the same guarantee a
                    # 2PC participant gives when a finalize delivery
                    # fails (topology.py relies on it already)
                    schemas = {
                        p: self.db.schema.get_or_default(p).describe()
                        for p in {pred for pred, _ in txn.staged}}
                    self._replicate_record_locked(
                        ("xstage", txn.start_ts, list(txn.staged),
                         schemas,
                         sorted(int(k) for k in txn.conflict_keys)))
                    with self.lock:
                        self._xstage_touched[txn.start_ts] = \
                            time.monotonic()
            return {"ok": True, "result": {
                "extensions": {"txn": {"start_ts": start_ts,
                                       "commit_ts": commit_ts}}}}
        if op == "task":
            # one attr-level task of a federated query (ref
            # worker/task.go:131 ProcessTaskOverNetwork landing on the
            # serving group): leader-only snapshot read at a global
            # read_ts. The first task of a query pays the quorum read
            # barrier; every task reconciles decided cross-group
            # commits <= read_ts first.
            read_ts = int(req.get("read_ts", 0))
            pred = req.get("pred")
            if pred and pred in self.db.moved_out \
                    and pred not in self.db.tablets:
                # stale-routed federated task after a cutover: typed,
                # so the coordinator re-fetches the map and re-fans
                raise TabletMisrouted(pred, self.db.moved_out[pred])
            if pred and req.get("whole") \
                    and pred in self.db.split_partial:
                # a coordinator whose map predates a split flip asks
                # for the WHOLE predicate here, but this group holds
                # only a hash range — answering would be silently
                # partial. (SplitRemoteTablet's per-shard fan-out
                # sends whole=False and is served normally.)
                raise TabletMisrouted(
                    pred, None,
                    f"tablet {pred!r} is split across groups; refresh "
                    "the tablet map and fan out per sub-tablet")
            # the coordinator's propagated budget: give up BEFORE the
            # quorum barrier (its round-trip is the expensive part)
            # and again before reading — a coordinator that already
            # timed out must not keep consuming this group's leader
            ctx = self._req_ctx(req)
            if ctx is not None:
                ctx.check("task")
            # EVERY task pays the quorum barrier: the client's leader
            # can change mid-query, and a once-per-query (or cached
            # per-term) barrier would let a fresh or partitioned
            # ex-leader serve committed-but-unapplied state. Barrier
            # first, then reconcile decided cross-group commits.
            self._read_barrier()
            if not self._reconcile_pending(upto_ts=read_ts):
                raise RuntimeError(
                    "cannot verify pending transactions against "
                    "the decision registry; retry")
            with self._write_lock:
                with self.lock:
                    if self.node.role != LEADER:
                        raise NotLeader(self.node.leader_id)
                    if ctx is not None:
                        ctx.check("task read")
                    return {"ok": True,
                            "result": self._run_task(req, read_ts)}
        if op == "xstage":
            # one group's fragment of a cross-group transaction,
            # replicated at stage time so the 2PC stage survives
            # leader changes (ref worker/mutation.go:432 proposeOrSend)
            from dgraph_tpu_torch.gql.nquad import nquad_from_wire
            start_ts = int(req["start_ts"])
            # chaos seam: delay/fail a group's 2PC stage — the
            # coordinator-dies-mid-stage and slow-participant nemeses
            # (an armed error surfaces to the coordinator, which
            # aborts at zero and clears staged fragments)
            failpoint.fire("txn.xstage")
            nqs = [(nquad_from_wire(t), bool(d)) for t, d in req["nqs"]]
            preds = {nq.predicate for nq, _ in nqs}
            subjects = []
            for nq, _ in nqs:
                try:  # split-tablet row routing needs resolved uids;
                    # blanks fail xstage_ops with its own error below
                    subjects.append((nq.predicate, int(nq.subject, 0)))
                except ValueError:
                    pass
            with self._write_lock:
                self._check_ownership(preds, subjects=subjects)
                with self.lock:
                    if self.node.role != LEADER:
                        raise NotLeader(self.node.leader_id)
                    staged, keys, schemas = self.db.xstage_ops(
                        start_ts, nqs)
            self._replicate_record(
                ("xstage", start_ts, staged, schemas,
                 sorted(int(k) for k in keys)))
            with self.lock:
                self._xstage_touched[start_ts] = time.monotonic()
            # stale stages (coordinator died) reconcile via zero's
            # decision registry on the same TTL as idle txns
            self._reconcile_pending(evict_older_s=300.0)
            return {"ok": True,
                    "result": {"keys": sorted(int(k) for k in keys)}}
        if op == "xfinalize":
            start_ts = int(req["start_ts"])
            commit_ts = int(req["commit_ts"])
            with self.lock:
                known = start_ts in self.db.pending_txns
            if known:
                self._drain_finalizes(hint=(commit_ts, start_ts))
            return {"ok": True, "result": {"applied": known}}
        if op == "alter":
            ctx = self._req_ctx(req)
            self._replicate_write(
                lambda db: db.alter(ctx=ctx, **req["kw"]))
            return {"ok": True, "result": {}}
        if op == "status":
            from dgraph_tpu_torch.utils import metrics
            with self.lock:
                lag = max(0, self.node.commit_index
                          - self.node.applied_index)
                if self.node.learner:
                    metrics.set_gauge("dgraph_learner_lag", lag)
                return {"ok": True, "result": {
                    "id": self.id, "group": self.group,
                    "role": self.node.role,
                    "leader": self.node.leader_id,
                    "term": self.node.term,
                    "applied": self.node.applied_index,
                    "learner": self.node.learner,
                    "lag": lag,
                    "watermark": self._applied_watermark(),
                    "tablets": sorted(self.db.tablets),
                    "pending": sorted(self.db.pending_txns),
                    "max_ts": self.db.coordinator.max_assigned()}}
        if op == "stats":
            # the wire analogue of HTTP /debug/stats (same payload,
            # histograms included), bundled with the request log and
            # counter snapshot so one poll carries a node's whole
            # observability surface over the cluster wire alone
            # (tools/dgtop.py itself polls the HTTP endpoints)
            from dgraph_tpu_torch.utils import metrics, reqlog, watchdog
            # self.lock only pins the db BINDING (restore rebinds it);
            # the stats walk itself runs unlocked — a cold cache
            # recomputes O(postings) aggregates, and holding the Raft
            # state lock for that would stall apply/commit into
            # election timeouts. debug_stats retries/degrades on
            # concurrent-apply races: a skewed count is fine, a
            # stalled quorum is not.
            with self.lock:
                db = self.db
            stats = db.debug_stats()
            stats["node"] = self.node_name
            stats["group"] = self.group
            stats["requests"] = reqlog.snapshot()
            stats["netfault"] = netfault.rules()
            stats["lastHeard"] = self.peer_ages()
            stats["alerts"] = watchdog.firing_summary()
            # the port's kernels launched in this process (an alpha
            # serving from the card launches them; nothing else counts)
            from dgraph_tpu_torch.ops.kernels import launch_counts
            stats["kernelLaunches"] = launch_counts()
            with self.lock:
                stats["learner"] = self.node.learner
                stats["learnerLag"] = max(
                    0, self.node.commit_index
                    - self.node.applied_index)
                if self.node.learner:
                    metrics.set_gauge("dgraph_learner_lag",
                                      stats["learnerLag"])
            metrics.collect_process_gauges()
            stats["counters"] = metrics.counters_snapshot()
            stats["gauges"] = metrics.gauges_snapshot()
            stats["histograms"] = metrics.histograms_snapshot()
            return {"ok": True, "result": stats}
        if op == "export_tablet":
            # tablet move, source side (worker/predicate_move.go:81).
            # _write_lock serializes against in-flight writes: anything
            # committed before the export is in the blob; anything
            # after re-checks Zero's map and sees the moving mark.
            with self._write_lock:
                with self.lock:
                    if self.node.role != LEADER:
                        raise NotLeader(self.node.leader_id)
                    pred = req["pred"]
                    if pred not in self.db.tablets:
                        return {"ok": False, "error":
                                f"tablet {pred!r} not served here"}
                    blob = wire.dumps(self.db.export_tablet(pred))
            return {"ok": True, "result": blob}
        if op == "import_tablet":
            # destination side: replicate the whole tablet as one
            # record so every group replica installs it
            payload = wire.loads(req["blob"])
            self._replicate_record(
                ("import_tablet", req["pred"], payload))
            return {"ok": True, "result": {}}
        if op == "drop_tablet":
            with self.lock:
                self._move_exports.pop(req["pred"], None)
                self._move_staging.pop(req["pred"], None)
            if req.get("move_dst") is not None:
                # post-flip source cleanup: drop AND tombstone, so a
                # stale-routed request gets a typed misroute
                self._replicate_record(
                    ("move_drop", req["pred"], int(req["move_dst"])))
            else:
                self._replicate_record(("drop_attr", req["pred"]))
            return {"ok": True, "result": {}}
        if op == "split_prune":
            # post-flip SPLIT source cleanup: keep only the rows
            # outside the moved hash range (idempotent — pruning an
            # already-pruned tablet removes nothing)
            with self.lock:
                self._move_exports.pop(req["pred"], None)
            self._replicate_record(
                ("split_prune", req["pred"], int(req["nshards"]),
                 int(req["shard"])))
            return {"ok": True, "result": {}}
        if op == "move_export_end":
            # release the cached export blob (aborted/finished move —
            # a multi-GB zlib blob must not sit pinned until the next
            # move of the same predicate)
            with self.lock:
                self._move_exports.pop(req["pred"], None)
                self._move_staging.pop(req["pred"], None)
            return {"ok": True, "result": {}}
        if op == "move_export_begin":
            # streaming move, source side (ref worker/predicate_move
            # .go:81 movePredicateHelper — but with writes LIVE): dump
            # once under the write lock (a consistent cut at snap_ts =
            # max_commit_ts), cache the compressed blob leader-locally,
            # serve it in re-deliverable chunks. Writes resume the
            # moment the dump finishes; everything committed after
            # snap_ts reaches the destination via move_deltas.
            import zlib
            pred = req["pred"]
            chunk = max(1, int(req.get("chunk_bytes", 1 << 20)))
            prefer = int(req.get("prefer_snap_ts", 0) or 0)
            with self.lock:
                exp = self._move_exports.get(pred)
            if exp is not None and prefer \
                    and exp["snap_ts"] == prefer:
                # the driver resumes an interrupted stream: the
                # destination's staged chunks match this cached
                # export, so serve THAT instead of re-dumping (a
                # fresh snap_ts would invalidate every staged chunk
                # and re-pay the dump's write stall)
                return {"ok": True, "result": {
                    "snap_ts": exp["snap_ts"],
                    "bytes": len(exp["blob"]),
                    "chunks": (len(exp["blob"]) + exp["chunk"] - 1)
                    // exp["chunk"]}}
            with self._write_lock:
                with self.lock:
                    if self.node.role != LEADER:
                        raise NotLeader(self.node.leader_id)
                    if pred not in self.db.tablets:
                        raise TabletMisrouted(
                            pred, self.db.moved_out.get(pred))
                    payload = self.db.export_tablet_move(
                        pred, int(req.get("nshards", 1) or 1),
                        req.get("shard"))
                    # serialize INSIDE the write lock: for
                    # whole-tablet moves the payload aliases the LIVE
                    # tab.deltas/edge_facets (dump_tablet does not
                    # copy them) — a commit racing the encode would
                    # mutate them mid-iteration
                    raw = wire.dumps(payload)
            blob = zlib.compress(raw, 1)
            with self.lock:
                self._move_exports[pred] = {
                    "snap_ts": payload["snap_ts"], "blob": blob,
                    "chunk": chunk}
            return {"ok": True, "result": {
                "snap_ts": payload["snap_ts"], "bytes": len(blob),
                "chunks": (len(blob) + chunk - 1) // chunk}}
        if op == "move_chunk":
            # one re-deliverable snapshot chunk (offset-keyed by seq);
            # a new source leader has no cache -> the driver re-begins
            failpoint.fire("move.snapshot_chunk")
            pred = req["pred"]
            with self.lock:
                exp = self._move_exports.get(pred)
            if exp is None or exp["snap_ts"] != int(req["snap_ts"]):
                return {"ok": False, "restage": True, "error":
                        f"no active export for {pred!r} at snap_ts "
                        f"{req['snap_ts']} (source leader changed?); "
                        "re-begin"}
            cs = exp["chunk"]
            seq = int(req["seq"])
            return {"ok": True, "result":
                    {"seq": seq,
                     "data": exp["blob"][seq * cs:(seq + 1) * cs]}}
        if op == "move_deltas":
            # catch-up tail, source side: raw EdgeOp batches (whole
            # commits, ascending) from the predicate's change log
            # after the destination's progress offset. LEADER-only:
            # the fence-drain decision needs the head that covers
            # every committed write, and a follower's log may lag.
            from dgraph_tpu_torch.cdc.changelog import OffsetTruncated
            with self.lock:
                if self.node.role != LEADER:
                    raise NotLeader(self.node.leader_id)
                db = self.db
            try:
                out = db.cdc.read_raw(req["pred"],
                                      after=int(req["after"]),
                                      limit=int(req.get("limit", 512)))
            except OffsetTruncated as e:
                # the bounded log evicted past the destination's
                # base: the driver must re-snapshot from a newer one.
                # `resyncTs` matches the HTTP 410 spelling; the
                # snake_case twin stays for older clients
                return {"ok": False, "error": str(e),
                        "truncated": {"pred": e.pred, "floor": e.floor,
                                      "resyncTs": e.resync_ts,
                                      "resync_ts": e.resync_ts}}
            if req.get("shard") is not None:
                from dgraph_tpu_torch.cluster.shard import filter_ops
                n = int(req.get("nshards", 1) or 1)
                out["batches"] = [
                    (ts, filter_ops(ops, n, int(req["shard"])))
                    for ts, ops in out["batches"]]
            return {"ok": True, "result": out}
        if op == "move_status":
            # source-side fence-drain facts — and the drain's
            # LINEARIZATION BARRIER: every commit on this group runs
            # its ownership check AND its apply under ONE _write_lock
            # hold, so by acquiring _write_lock here (after the fence
            # committed at zero) we know any write that passed its
            # pre-fence ownership check has fully applied (its CDC
            # entry is covered by the `cdc_head` we return), and any
            # write still waiting for the lock will re-check
            # ownership, see the fence, and be rejected. Without this
            # barrier a commit in flight across the fence could land
            # AFTER the drain's last delta read — an acked write
            # silently lost at the flip (review finding). Also
            # reports: any replicated 2PC stage still pending on this
            # predicate (its finalize would land here post-flip).
            pred = req["pred"]
            with self._write_lock:
                with self.lock:
                    if self.node.role != LEADER:
                        raise NotLeader(self.node.leader_id)
                    pending = any(
                        any(p == pred for p, _ in staged)
                        for staged, _k
                        in self.db.pending_txns.values())
                    tab = self.db.tablets.get(pred)
                    mct = tab.max_commit_ts if tab is not None else 0
                    head = self.db.cdc.head(pred)
            return {"ok": True, "result": {"pending_stage": pending,
                                           "max_commit_ts": mct,
                                           "cdc_head": head}}
        if op == "move_stage_chunk":
            # destination side: chunks land in a leader-local staging
            # buffer (NOT replicated — a died leader's staging is
            # simply re-streamed, chunks are re-deliverable)
            pred = req["pred"]
            snap_ts = int(req["snap_ts"])
            with self.lock:
                if self.node.role != LEADER:
                    raise NotLeader(self.node.leader_id)
                st = self._move_staging.get(pred)
                if st is None or st["snap_ts"] != snap_ts:
                    st = self._move_staging[pred] = {
                        "snap_ts": snap_ts,
                        "total": int(req["total"]), "chunks": {}}
                st["chunks"][int(req["seq"])] = req["data"]
                have = len(st["chunks"])
            return {"ok": True, "result": {"have": have}}
        if op == "move_install":
            # all chunks staged: assemble and replicate the whole
            # tablet as ONE import_tablet record so every group
            # replica installs identical state, then clear staging
            import zlib
            pred = req["pred"]
            snap_ts = int(req["snap_ts"])
            with self.lock:
                st = self._move_staging.get(pred)
                whole = st is not None and st["snap_ts"] == snap_ts \
                    and len(st["chunks"]) >= st["total"]
                blob = b"".join(st["chunks"][i]
                                for i in range(st["total"])) \
                    if whole else b""
            if not whole:
                return {"ok": False, "restage": True, "error":
                        f"staging for {pred!r}@{snap_ts} incomplete "
                        "(destination leader changed?); re-stream"}
            payload = wire.loads(zlib.decompress(blob))

            def move_in_ledger() -> bool:
                if self.zero is None:
                    return True
                got = self.zero.request({"op": "tablet_map"})
                return not got.get("ok") or pred in \
                    got["result"].get("moves", {})
            # an operator abort can race the driver's in-flight
            # stream: its cleanup drop lands, then THIS install would
            # re-create the orphan — and nothing would ever remove
            # it. Check the ledger immediately BEFORE replicating
            # (after the slow decompress, shrinking the TOCTOU) and
            # again AFTER: an abort that slipped between the check
            # and the install gets its orphan dropped right here.
            if not move_in_ledger():
                with self.lock:
                    self._move_staging.pop(pred, None)
                return {"ok": False, "error":
                        f"move of {pred!r} is no longer in zero's "
                        "ledger (aborted?); install refused"}
            self._replicate_record(("import_tablet", pred, payload))
            with self.lock:
                self._move_staging.pop(pred, None)
            if not move_in_ledger():
                self._replicate_record(("drop_attr", pred))
                return {"ok": False, "error":
                        f"move of {pred!r} aborted during install; "
                        "installed copy dropped"}
            return {"ok": True, "result": {
                "max_commit_ts": int(payload["tablet"]
                                     .get("max_commit_ts", 0))}}
        if op == "repl_install":
            # cross-cluster replication install (cluster/replication
            # .py): same staged-chunk assembly as move_install but
            # WITHOUT the zero move-ledger check — the STANDBY's zero
            # has no move entry for a replicated tablet; its cluster-
            # wide write fence is what keeps client writes out, and
            # replication applies land through the replicated-record
            # path below, never the ownership check
            import zlib
            pred = req["pred"]
            snap_ts = int(req["snap_ts"])
            with self.lock:
                st = self._move_staging.get(pred)
                whole = st is not None and st["snap_ts"] == snap_ts \
                    and len(st["chunks"]) >= st["total"]
                blob = b"".join(st["chunks"][i]
                                for i in range(st["total"])) \
                    if whole else b""
            if not whole:
                return {"ok": False, "restage": True, "error":
                        f"staging for {pred!r}@{snap_ts} incomplete "
                        "(standby leader changed?); re-stream"}
            payload = wire.loads(zlib.decompress(blob))
            self._replicate_record(("import_tablet", pred, payload))
            with self.lock:
                self._move_staging.pop(pred, None)
            return {"ok": True, "result": {
                "max_commit_ts": int(payload["tablet"]
                                     .get("max_commit_ts", 0))}}
        if op == "move_apply":
            # catch-up batches landing on the destination, replicated
            # as ONE move_delta record (idempotent: the replicated
            # max_commit_ts guard skips re-delivered commits)
            failpoint.fire("move.catchup")
            pred = req["pred"]
            with self.lock:
                installed = pred in self.db.tablets
            if not installed:
                return {"ok": False, "restage": True, "error":
                        f"tablet {pred!r} not installed here "
                        "(destination leader changed?); re-stream"}
            batches = [(int(ts), list(ops))
                       for ts, ops in req["batches"]]
            if batches:
                self._replicate_record(("move_delta", pred, batches))
            with self.lock:
                tab = self.db.tablets.get(pred)
                mct = tab.max_commit_ts if tab is not None else 0
            return {"ok": True, "result": {"max_commit_ts": mct}}
        if op == "move_dst_status":
            # the driver's resume point after ANY crash: what the
            # destination durably holds (installed tablet + its commit
            # watermark + whether it is a hash-range shard copy — the
            # provenance bit that keeps a stale shard orphan from
            # being adopted as a whole-tablet move's base) and what is
            # merely staged
            with self.lock:
                if self.node.role != LEADER:
                    raise NotLeader(self.node.leader_id)
                tab = self.db.tablets.get(req["pred"])
                st = self._move_staging.get(req["pred"])
                return {"ok": True, "result": {
                    "installed": tab is not None,
                    "split_partial": req["pred"]
                    in self.db.split_partial,
                    "max_commit_ts": tab.max_commit_ts
                    if tab is not None else 0,
                    "staged_snap_ts": st["snap_ts"] if st else 0,
                    "have_chunks": len(st["chunks"]) if st else 0}}
        if op == "subscribe":
            # CDC long-poll against THIS node's change logs
            # (cdc/changelog.py). Deliberately NOT leader-gated:
            # offsets are deterministic functions of the replicated
            # record stream, so any replica serves the same stream and
            # a subscriber fails over freely — the whole point of the
            # dgchaos CDC nemesis. Also deliberately outside admission
            # (_ADMITTED_OPS): a long-poll parks its serving thread on
            # a condition, not the engine, and must not starve writes.
            from dgraph_tpu_torch.cdc.changelog import OffsetTruncated
            with self.lock:
                db = self.db
            try:
                out = db.cdc.read(
                    str(req.get("pred", "")),
                    after=int(req.get("offset", 0)),
                    limit=int(req.get("limit", 256)),
                    wait_s=float(req.get("wait_ms", 0)) / 1000.0,
                    sub_id=str(req.get("id", "")))
            except OffsetTruncated as e:
                # typed on the wire so ClusterClient.subscribe can
                # re-raise it (not a generic RuntimeError): the
                # re-sync path is client logic. `resyncTs` matches the
                # HTTP 410 spelling (one documented key on BOTH
                # surfaces); the snake_case twin stays for old clients
                return {"ok": False, "error": str(e),
                        "truncated": {"pred": e.pred,
                                      "floor": e.floor,
                                      "resyncTs": e.resync_ts,
                                      "resync_ts": e.resync_ts}}
            return {"ok": True, "result": out}
        if op == "hello":
            # connection-time version negotiation (storage/versions):
            # both sides speak min(protocol)s; the format + build
            # stamps let a rolling upgrade observe the fleet's spread
            from dgraph_tpu_torch.storage.versions import negotiate, \
                versions_payload
            out = versions_payload()
            out["negotiated"] = negotiate(
                int(req.get("protocol_version", 0)))
            return {"ok": True, "result": out}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def watchdog_signals(self) -> dict:
        """Alpha signals: base raft lag/peer silence + the slowest
        CDC subscriber's unread-entry lag."""
        out = super().watchdog_signals()
        with self.lock:
            db = self.db
        try:
            subs = db.cdc.stats().get("subscribers", {})
            lags = [s.get("lag", 0) for s in subs.values()]
            if lags:
                out["cdc_max_lag"] = float(max(lags))
        except Exception:  # noqa: BLE001 — a stats race must not  # dglint: disable=DG07 (watchdog tick provider; no request context)
            pass  # kill the tick
        return out

    def watchdog_context(self) -> dict:
        """Planner/plan-cache state for the incident bundle (NOT the
        full debug_stats: the O(store) tablet walk has no place on a
        capture path that fires mid-incident)."""
        with self.lock:
            db = self.db
        return {
            "planCache": db.plan_cache.stats()
            if db.plan_cache is not None else None,
            "planner": db.planner_impl.stats()
            if db.planner_impl is not None else {"mode": "static"},
            "deviceCache": db.device_cache.stats(),
            "resultCache": db.result_cache.stats()
            if db.result_cache is not None else None,
        }

    def attach_watchdog(self, wd) -> None:
        super().attach_watchdog(wd)
        wd.register_context("engine", self.watchdog_context)

    def debug_stats_payload(self) -> dict:
        """The debug HTTP listener's /debug/stats body: the engine's
        statistics plane + this node's identity and the request ring.
        Same locking posture as the wire `stats` op — self.lock only
        pins the db binding, the walk runs unlocked (debug_stats
        degrades on concurrent-apply races rather than stalling raft)."""
        from dgraph_tpu_torch.utils import reqlog, watchdog
        with self.lock:
            db = self.db
        from dgraph_tpu_torch.storage.versions import versions_payload
        stats = db.debug_stats()
        stats["node"] = self.node_name
        stats["group"] = self.group
        stats["requests"] = reqlog.snapshot()
        stats["netfault"] = netfault.rules()
        stats["lastHeard"] = self.peer_ages()
        stats["alerts"] = watchdog.firing_summary()
        stats["versions"] = versions_payload()
        with self.lock:
            stats["learner"] = self.node.learner
            stats["learnerLag"] = max(0, self.node.commit_index
                                      - self.node.applied_index)
            if self.node.learner:
                metrics.set_gauge("dgraph_learner_lag",
                                  stats["learnerLag"])
        return stats

    def health_payload(self) -> dict:
        out = super().health_payload()
        out["group"] = self.group
        with self._admission:
            out["pending"] = self._inflight
        out["maxPending"] = self.max_pending
        return out


class _MoveDataError(RuntimeError):
    """A tablet move's export/import was REJECTED by a group (vs a
    transient infra error): these count toward the pre-flip abort
    threshold."""


class ZeroServer(RaftServer):
    """The replicated coordinator quorum (dgraph/cmd/zero).

    Unlike the Alpha group, commands execute AT APPLY TIME on every
    replica — the state machine is deterministic, so each member
    computes identical results and the proposer reads its local apply
    result (zero/raft.go:619 applyProposal over the oracle/leases).
    """

    def __init__(self, node_id: int, raft_peers, client_addr,
                 storage=None, move_throttle_mb_s: float = 64.0,
                 move_chunk_bytes: int = 1 << 20,
                 move_fence_lag: int = 16,
                 move_fence_timeout_s: float = 5.0,
                 rebalance_interval_s: float = 0.0,
                 rebalance_band: float = 1.4,
                 split_heat: float = 0.0,
                 rebalance_pin: str = "",
                 rebalance_cooldown_s: float = 120.0,
                 standby_of=None, **kw):
        from dgraph_tpu_torch.cluster.zero import ZeroState
        self.state = ZeroState()
        self.node_name = f"zero-n{node_id}"
        # live-move knobs (docs/deployment.md "Tablet rebalancing"):
        #   move_throttle_mb_s   snapshot streaming budget (bytes/s)
        #   move_fence_lag       fence once catch-up is <= this many
        #                        change-log entries behind
        #   move_fence_timeout_s unfence (writes resume) if the drain
        #                        hasn't converged by then
        self.move_throttle_mb_s = float(move_throttle_mb_s)
        self.move_chunk_bytes = int(move_chunk_bytes)
        self.move_fence_lag = int(move_fence_lag)
        self.move_fence_timeout_s = float(move_fence_timeout_s)
        self.rebalance_interval_s = float(rebalance_interval_s)
        self.rebalance_band = float(rebalance_band)
        self.split_heat = float(split_heat)
        self.rebalance_pin = frozenset(
            p.strip() for p in str(rebalance_pin).split(",")
            if p.strip())
        self.rebalance_cooldown_s = float(rebalance_cooldown_s)
        super().__init__(node_id, raft_peers, client_addr,
                         storage=storage, **kw)
        # leader-only tablet-move driver: executes the ledger's moves
        # (snapshot stream -> CDC catch-up -> bounded-lag fence ->
        # flip -> source drop/prune), each phase transition
        # raft-persisted so a NEW leader resumes mid-flight moves from
        # the exact phase (ref zero/tablet.go:62 movetablet run by
        # zero's leader). _move_progress is leader-local observability
        # (bytes streamed, lag, fence clock) — recomputed after a
        # leader change, never authoritative.
        self._move_attempts: dict[str, int] = {}
        self._move_progress: dict[str, dict] = {}
        # leader-local cluster alert aggregation (same posture as
        # _move_progress: observability, never replicated): node name
        # -> {"alerts": [...], "age_mono": float} from the firing
        # summaries alphas piggyback on their heat reports
        self._node_alerts: dict[str, dict] = {}
        # node name -> monotonic ts of its last heat/status report:
        # the report_silent watchdog's clock (leader-local too)
        self._node_report_mono: dict[str, float] = {}
        threading.Thread(target=self._move_driver_loop, daemon=True,
                         name=f"zero-moves-{node_id}").start()
        if self.rebalance_interval_s > 0:
            threading.Thread(target=self._rebalance_loop, daemon=True,
                             name=f"zero-rebalance-{node_id}").start()
        # cross-cluster async replication: this zero quorum fronts a
        # STANDBY cluster tailing the primary at `standby_of` (the
        # primary zero's client addrs). Leader-only, like the move
        # driver; the replicated repl_phase/write_fence let a new
        # leader resume (cluster/replication.py)
        self.repl = None
        if standby_of:
            from dgraph_tpu_torch.cluster.replication import ReplicationDriver
            self.repl = ReplicationDriver(self, dict(standby_of))
            threading.Thread(target=self.repl.run, daemon=True,
                             name=f"zero-repl-{node_id}").start()

    def _group_client(self, gid: int):
        """ClusterClient to an alpha group from the membership
        registry (alphas register their client addrs on connect)."""
        from dgraph_tpu_torch.cluster.client import ClusterClient
        with self.lock:
            # learners never lead and never serve writes: the move/
            # replication drivers talk to voters only
            addrs = {rec["id"]: tuple(rec["client"])
                     for rec in self.state.alphas.values()
                     if rec["group"] == gid and not rec.get("learner")}
        return ClusterClient(addrs, timeout=30.0) if addrs else None

    def _move_driver_loop(self, tick_s: float = 0.5):
        while not self._stop.wait(tick_s):
            with self.lock:
                if self.node.role != LEADER:
                    continue
                pending = {p: dict(m)
                           for p, m in self.state.move_queue.items()}
            # counters for moves no longer in the ledger (finished or
            # externally aborted) must not doom a future retry
            for p in list(self._move_attempts):
                if p not in pending:
                    self._move_attempts.pop(p, None)
            for pred, mv in pending.items():
                try:
                    self._drive_move(pred, mv)
                except _MoveDataError as e:
                    # the data phase itself failed (export/import
                    # rejected): count toward the abort threshold —
                    # transient infra errors (registry warm-up, group
                    # elections) retry forever instead
                    log.warning("move_data_retry", pred=pred,
                                error=str(e)[:200])
                    n = self._move_attempts.get(pred, 0) + 1
                    self._move_attempts[pred] = n
                    if n > 20 and mv["phase"] in (
                            "start", "snapshotting", "catching_up",
                            "fenced"):  # any PRE-FLIP phase may abort
                        try:
                            self._abort_move(pred, mv)
                        except Exception:  # noqa: BLE001 — an abort  # dglint: disable=DG07 (zero's move driver is a daemon; no request context)
                            pass  # hiccup must never kill the driver
                except Exception as e:  # noqa: BLE001 — retry next tick  # dglint: disable=DG07 (zero's move driver is a daemon; no request context)
                    log.warning("move_drive_retry", pred=pred,
                                error=str(e)[:200])
                    # post-flip we NEVER abort: the destination owns
                    # the data; keep retrying the source drop forever

    def _abort_move(self, pred: str, mv: dict):
        """Pre-flip abort: route stays with the source (which never
        stopped serving); the copy staged/installed on the destination
        must be dropped or it lives on as a stale orphan. Post-flip
        moves NEVER come here — the destination owns the data."""
        dst_cl = self._group_client(mv["dst"])
        if dst_cl is not None:
            try:
                dst_cl.request({"op": "drop_tablet", "pred": pred})
            except Exception:  # noqa: BLE001 — best-effort cleanup  # dglint: disable=DG07 (move-abort cleanup; no request context)
                pass
            finally:
                dst_cl.close()
        src_cl = self._group_client(mv.get("src", -1))
        if src_cl is not None:
            try:
                # release the source's cached export blob too — an
                # aborted multi-GB move must not pin it until the
                # next move of the same predicate
                src_cl.request({"op": "move_export_end",
                                "pred": pred})
            except Exception:  # noqa: BLE001 — best-effort cleanup  # dglint: disable=DG07 (move-abort cleanup; no request context)
                pass
            finally:
                src_cl.close()
        self.propose_and_wait(("tablet_move_abort", (pred, mv["dst"])))
        with self.lock:
            self._move_attempts.pop(pred, None)
            self._move_progress.pop(pred, None)
        metrics.inc_counter("dgraph_tablet_moves_total",
                            labels={"phase": "aborted"})

    def _advance(self, pred: str, mv: dict, phase: str,
                 snap_ts: int = 0):
        """Commit one phase transition through the quorum; the local
        ledger copy follows only on success, so a deposed leader can
        never act on a phase the quorum rejected."""
        ok, res = self.propose_and_wait(
            ("move_phase", (pred, mv["dst"], phase, int(snap_ts))))
        if not ok or not res:
            raise RuntimeError(f"move phase {phase!r} not committed")
        mv["phase"] = phase
        if snap_ts:
            mv["snap_ts"] = int(snap_ts)
        metrics.inc_counter("dgraph_tablet_moves_total",
                            labels={"phase": phase})
        log.info("move_phase", pred=pred, phase=phase,
                 snap_ts=snap_ts or mv.get("snap_ts", 0))

    def _move_pair(self, mv: dict):
        src_cl = self._group_client(mv["src"])
        dst_cl = self._group_client(mv["dst"])
        if src_cl is None or dst_cl is None:
            if src_cl is not None:
                src_cl.close()
            if dst_cl is not None:
                dst_cl.close()
            raise RuntimeError(
                f"groups {mv['src']}->{mv['dst']} not registered yet")
        return src_cl, dst_cl

    def _drive_move(self, pred: str, mv: dict):
        """One driver pass over a ledger entry — the phase machine
        snapshotting -> catching_up -> fenced -> flipped(-> dropped).
        Every transition is raft-persisted (move_phase /
        tablet_move_done), so a NEW zero leader picks up exactly
        here; the data steps are offset-keyed and re-deliverable, so
        re-driving any phase is idempotent."""
        dst = mv["dst"]
        src = mv.get("src")
        if src is None or src == dst:
            self._abort_move(pred, mv)
            return
        with self.lock:
            prog = self._move_progress.setdefault(
                pred, {"bytes": 0, "lag": None,
                       "started": time.monotonic(),
                       "fence_started": None, "fence_ms": None})
            if prog.get("phase") != mv["phase"]:
                # stuck-in-phase age for the move_stuck watchdog:
                # reset on every phase TRANSITION, so a healthy move
                # marching through phases never looks stuck while a
                # wedged catch-up does
                prog["phase"] = mv["phase"]
                prog["phase_mono"] = time.monotonic()
        if mv["phase"] in ("start", "snapshotting"):
            # ("start" = a legacy pre-phase-machine ledger entry:
            # drive it through the streaming path too)
            if mv["phase"] == "start":
                mv["phase"] = "snapshotting"
            self._phase_snapshot(pred, mv, prog)
        if mv["phase"] == "catching_up":
            self._phase_catchup(pred, mv, prog)
        if mv["phase"] == "fenced":
            self._phase_fenced(pred, mv, prog)
        if mv["phase"] == "flipped":
            self._phase_drop(pred, mv, prog)

    def _phase_snapshot(self, pred: str, mv: dict, prog: dict):
        """Stream the compressed base snapshot source -> destination
        in throttled, re-deliverable chunks. The source serves reads
        AND writes throughout (only the in-memory dump itself briefly
        holds the source's write lock)."""
        src_cl, dst_cl = self._move_pair(mv)
        try:
            st = dst_cl._unwrap(dst_cl.request(
                {"op": "move_dst_status", "pred": pred}))
            if st["installed"]:
                # Resume from the installed copy ONLY when its
                # provenance matches this move: a WHOLE-tablet move
                # must never adopt a shard-only orphan (left by a
                # failed abort cleanup) as its base — post-flip the
                # other shards' rows would be silently gone; and a
                # SPLIT move re-streams rather than trusting an
                # unattributable copy. Mismatches are dropped (the
                # destination is unrouted pre-flip) and re-streamed.
                if mv.get("shard") is None \
                        and not st.get("split_partial"):
                    self._advance(pred, mv, "catching_up",
                                  snap_ts=int(st["max_commit_ts"]))
                    return
                dst_cl.request({"op": "drop_tablet", "pred": pred})
            try:
                begin = src_cl._unwrap(src_cl.request(
                    {"op": "move_export_begin", "pred": pred,
                     "shard": mv.get("shard"),
                     "nshards": mv.get("nshards", 1),
                     # resume an interrupted stream when the source
                     # still caches the export the destination's
                     # staged chunks belong to (chunks are staged
                     # sequentially, so have_chunks IS the resume seq)
                     "prefer_snap_ts": st.get("staged_snap_ts", 0),
                     "chunk_bytes": self.move_chunk_bytes}))
            except RuntimeError as e:
                raise _MoveDataError(str(e)) from e
            snap_ts = int(begin["snap_ts"])
            nchunks = int(begin["chunks"])
            first_seq = 0
            if snap_ts and snap_ts == int(st.get("staged_snap_ts", 0)):
                first_seq = min(int(st.get("have_chunks", 0)), nchunks)
            budget = self.move_throttle_mb_s * 1e6  # bytes/s
            for seq in range(first_seq, nchunks):
                if self._stop.is_set() or not self.is_leader():
                    return
                got = src_cl.request(
                    {"op": "move_chunk", "pred": pred,
                     "snap_ts": snap_ts, "seq": seq})
                if not got.get("ok"):
                    # a new source leader has no export cache: next
                    # driver tick re-begins from a fresh snapshot
                    raise _MoveDataError(
                        f"chunk {seq}: {got.get('error')}")
                data = got["result"]["data"]
                dst_cl._unwrap(dst_cl.request(
                    {"op": "move_stage_chunk", "pred": pred,
                     "snap_ts": snap_ts, "seq": seq,
                     "total": nchunks, "data": data}))
                prog["bytes"] += len(data)
                metrics.inc_counter("dgraph_move_streamed_bytes_total",
                                    len(data))
                if budget > 0 and data:
                    time.sleep(len(data) / budget)  # --move-throttle
            inst = dst_cl.request({"op": "move_install", "pred": pred,
                                   "snap_ts": snap_ts})
            if not inst.get("ok"):
                if inst.get("restage"):
                    return  # dst leader changed mid-stream: re-stream
                raise _MoveDataError(f"install: {inst.get('error')}")
            self._advance(pred, mv, "catching_up", snap_ts=snap_ts)
        finally:
            src_cl.close()
            dst_cl.close()

    def _catchup_once(self, pred: str, mv: dict, prog: dict,
                      src_cl, dst_cl) -> Optional[int]:
        """One catch-up round: read the destination's watermark, pull
        the next raw batch from the source's change log, apply it.
        Returns the lag (entries still behind) or None when the move
        must restart from a fresh snapshot (log truncated / the
        destination lost its copy)."""
        from dgraph_tpu_torch.cdc.changelog import offset_for_ts
        st = dst_cl._unwrap(dst_cl.request(
            {"op": "move_dst_status", "pred": pred}))
        if not st["installed"]:
            self._advance(pred, mv, "snapshotting")
            return None
        after = offset_for_ts(max(int(st["max_commit_ts"]),
                                  int(mv.get("snap_ts", 0))))
        got = src_cl.request(
            {"op": "move_deltas", "pred": pred, "after": after,
             "limit": 512, "shard": mv.get("shard"),
             "nshards": mv.get("nshards", 1)})
        if not got.get("ok"):
            if got.get("truncated"):
                # the bounded change log evicted past our base while
                # we streamed: DROP the destination's stale copy
                # first (it is unrouted pre-flip), then restart from
                # a newer snapshot — leaving it installed would make
                # _phase_snapshot short-circuit straight back to
                # catching_up with the same too-old watermark, a
                # silent snapshotting<->truncated livelock
                dst_cl.request({"op": "drop_tablet", "pred": pred})
                self._advance(pred, mv, "snapshotting")
                return None
            raise _MoveDataError(f"deltas: {got.get('error')}")
        res = got["result"]
        if res["batches"]:
            ap = dst_cl.request({"op": "move_apply", "pred": pred,
                                 "batches": res["batches"]})
            if not ap.get("ok"):
                if ap.get("restage"):
                    self._advance(pred, mv, "snapshotting")
                    return None
                raise _MoveDataError(f"apply: {ap.get('error')}")
        lag = int(res["behind"]) + sum(len(ops) for _, ops
                                       in res["batches"])
        prog["lag"] = int(res["behind"])
        metrics.set_gauge("dgraph_move_catchup_lag", prog["lag"],
                          labels={"pred": pred})
        return 0 if not res["batches"] and not res["behind"] else lag

    def _phase_catchup(self, pred: str, mv: dict, prog: dict):
        """Tail the source's change log until lag falls under the
        fence bound, then fence (a SHORT single-predicate write fence
        — reads never fence)."""
        src_cl, dst_cl = self._move_pair(mv)
        try:
            for _ in range(64):  # bounded per driver tick
                if self._stop.is_set() or not self.is_leader():
                    return
                lag = self._catchup_once(pred, mv, prog, src_cl, dst_cl)
                if lag is None:
                    return  # restarting from snapshot
                if lag <= self.move_fence_lag:
                    failpoint.fire("move.fence")
                    self._advance(pred, mv, "fenced")
                    prog["fence_started"] = time.monotonic()
                    return
            # still far behind: next driver tick continues from the
            # destination's durable watermark
        finally:
            src_cl.close()
            dst_cl.close()

    def _phase_fenced(self, pred: str, mv: dict, prog: dict):
        """Writes to this one predicate are fenced (zero's moving
        mark): drain the last deltas to lag ZERO, verify no 2PC stage
        still pends on the source, then commit the ownership flip. If
        the drain doesn't converge inside the fence budget, UNFENCE —
        writes resume, catch-up continues, nothing is lost."""
        src_cl, dst_cl = self._move_pair(mv)
        try:
            if prog.get("fence_started") is None:
                prog["fence_started"] = time.monotonic()  # resumed
            deadline = prog["fence_started"] + self.move_fence_timeout_s
            while True:
                if self._stop.is_set() or not self.is_leader():
                    return
                lag = self._catchup_once(pred, mv, prog, src_cl,
                                         dst_cl)
                if lag is None:
                    prog["fence_started"] = None
                    return  # restarting from snapshot (unfenced)
                if lag == 0:
                    # the barrier read: move_status acquires the
                    # source's WRITE lock before reading the CDC head,
                    # so any commit that slipped past its pre-fence
                    # ownership check has fully applied and is covered
                    # by cdc_head — the drain is complete only once
                    # the destination's watermark covers that head
                    sst = src_cl._unwrap(src_cl.request(
                        {"op": "move_status", "pred": pred}))
                    st = dst_cl._unwrap(dst_cl.request(
                        {"op": "move_dst_status", "pred": pred}))
                    from dgraph_tpu_torch.cdc.changelog import offset_for_ts
                    covered = offset_for_ts(
                        max(int(st["max_commit_ts"]),
                            int(mv.get("snap_ts", 0))))
                    if not sst["pending_stage"] \
                            and covered >= int(sst["cdc_head"]):
                        break  # fully drained: flip
                if time.monotonic() > deadline:
                    # drain did not converge (pending 2PC stage, write
                    # storm): unfence so the source serves writes
                    # again; catch-up resumes and re-fences later
                    self._advance(pred, mv, "catching_up")
                    prog["fence_started"] = None
                    return
                time.sleep(0.02)
            prog["fence_ms"] = round(
                (time.monotonic() - prog["fence_started"]) * 1000, 1)
            failpoint.fire("move.flip")
            ok, flipped = self.propose_and_wait(
                ("tablet_move_done", (pred, mv["dst"])))
            if not ok or not flipped:
                raise RuntimeError("ownership flip not committed")
            mv["phase"] = "flipped"
            metrics.inc_counter("dgraph_tablet_moves_total",
                                labels={"phase": "flipped"})
            log.info("move_flipped", pred=pred, dst=mv["dst"],
                     fence_ms=prog["fence_ms"])
        finally:
            src_cl.close()
            dst_cl.close()

    def _phase_drop(self, pred: str, mv: dict, prog: dict):
        """Post-flip: the destination owns and serves; retire the
        source copy — whole-tablet moves drop + tombstone (typed
        misroutes for stale clients), split moves prune the moved hash
        range. Idempotent; a resumed leader re-issues freely. NEVER
        aborts — post-flip the destination's copy is the only one
        routed to."""
        src = mv.get("src")
        if src is not None and src != mv["dst"]:
            src_cl = self._group_client(src)
            if src_cl is None:
                raise RuntimeError(f"group {src} unreachable")
            try:
                if mv.get("shard") is not None:
                    resp = src_cl.request(
                        {"op": "split_prune", "pred": pred,
                         "nshards": mv.get("nshards", 2),
                         "shard": mv["shard"]})
                else:
                    resp = src_cl.request(
                        {"op": "drop_tablet", "pred": pred,
                         "move_dst": mv["dst"]})
                if not resp.get("ok") and "not served" not in str(
                        resp.get("error", "")):
                    raise RuntimeError(
                        f"source drop failed: {resp.get('error')}")
            finally:
                src_cl.close()
        self.propose_and_wait(("move_finish", (pred,)))
        with self.lock:
            self._move_attempts.pop(pred, None)
            done = self._move_progress.pop(pred, None)
        if done is not None:
            metrics.observe(
                "dgraph_move_duration_ms",
                (time.monotonic() - done["started"]) * 1000)
        metrics.set_gauge("dgraph_move_catchup_lag", 0,
                          labels={"pred": pred})
        metrics.inc_counter("dgraph_tablet_moves_total",
                            labels={"phase": "dropped"})
        log.info("move_complete", pred=pred, dst=mv["dst"],
                 shard=mv.get("shard"))

    # ------------------------------------------------------ rebalancer

    def _rebalance_loop(self):
        """Leader-only heat-driven rebalancing (ref zero/tablet.go:62
        rebalanceTablets, every --rebalance_interval): each tick feeds
        the replicated stats (heat EWMAs, sizes, tablet map) to the
        pure planner (cluster/rebalance.py) and files at most ONE
        move/split request — the ledger serializes execution, and
        one-step-at-a-time keeps a bad heuristic from thrashing the
        keyspace."""
        from dgraph_tpu_torch.cluster.rebalance import RebalanceConfig, \
            plan_rebalance
        cfg = RebalanceConfig(band=self.rebalance_band,
                              split_heat=self.split_heat,
                              pinned=self.rebalance_pin)
        # leader-local move cooldown: a tablet moved recently is
        # frozen for rebalance_cooldown_s so a heat EWMA still
        # re-equilibrating after the move cannot thrash it straight
        # back (the first bench run moved `knows` 1->2 then 2->1)
        recent: dict[str, float] = {}
        while not self._stop.wait(self.rebalance_interval_s):
            with self.lock:
                if self.node.role != LEADER:
                    continue
                if self.state.move_queue:
                    continue  # one move at a time
                view = {
                    "tablets": dict(self.state.tablets),
                    "splits": {p: dict(s) for p, s
                               in self.state.splits.items()},
                    "moving": dict(self.state.moving),
                    "sizes": dict(self.state.sizes),
                    "heat": dict(self.state.heat),
                    "groups": sorted({rec["group"] for rec
                                      in self.state.alphas.values()}),
                }
            now = time.monotonic()
            for p in list(recent):
                if now - recent[p] > self.rebalance_cooldown_s:
                    del recent[p]
            view["frozen"] = sorted(recent)
            plan = plan_rebalance(view, cfg)
            if plan is None:
                continue
            try:
                ok, accepted = self.propose_and_wait(
                    ("move_request", plan.args()))
                if ok and accepted:
                    recent[plan.pred] = now
                log.info("rebalance_proposed", kind=plan.kind,
                         pred=plan.pred, dst=plan.dst,
                         shard=plan.shard, accepted=bool(ok and
                                                         accepted))
            except Exception as e:  # noqa: BLE001 — keep rebalancing  # dglint: disable=DG07 (rebalancer daemon; no request context)
                log.warning("rebalance_retry", error=str(e)[:200])

    def sm_apply(self, origin, cmd) -> Any:
        return self.state.apply(cmd)

    def sm_snapshot(self):
        return self.state.snapshot()

    def sm_restore(self, snap):
        from dgraph_tpu_torch.cluster.zero import ZeroState
        self.state = ZeroState.from_snapshot(snap)

    def handle_request(self, req: dict) -> dict:
        conf = self.handle_conf_request(req)
        if conf is not None:
            return conf
        op = req.get("op")
        if op == "status":
            with self.lock:
                return {"ok": True, "result": {
                    "id": self.id, "role": self.node.role,
                    "leader": self.node.leader_id,
                    "applied": self.node.applied_index,
                    "max_ts": self.state.max_ts,
                    "next_uid": self.state.next_uid}}
        if op == "tablet_map":
            # routing table read (ref zero.go:410 /state) — leader-only
            # so a lagging follower can never serve a stale map that
            # routes writes to a tablet's old owner after a move.
            # `moving` fences WRITES only (the short fenced phase);
            # `moves` is the live ledger (clients wait on it);
            # `splits` routes hash-range sub-tablets.
            with self.lock:
                if self.node.role != LEADER:
                    raise NotLeader(self.node.leader_id)
                return {"ok": True, "result": {
                    "tablets": dict(self.state.tablets),
                    "moving": dict(self.state.moving),
                    "splits": {p: dict(s) for p, s
                               in self.state.splits.items()},
                    "moves": {p: dict(m) for p, m
                              in self.state.move_queue.items()},
                    "sizes": dict(self.state.sizes),
                    # cluster-wide client-write fence + replication
                    # role — every alpha write consults this map, so
                    # the fence takes effect on the NEXT write
                    "fence": self.state.write_fence,
                    "repl_phase": self.state.repl_phase}}
        if op == "cluster_state":
            # membership introspection (ref zero /state) — exposes the
            # split sub-tablet routing and per-tablet heat too
            with self.lock:
                return {"ok": True, "result": {
                    "alphas": {k: dict(v)
                               for k, v in self.state.alphas.items()},
                    "tablets": dict(self.state.tablets),
                    "splits": {p: dict(s) for p, s
                               in self.state.splits.items()},
                    "moves": {p: dict(m) for p, m
                              in self.state.move_queue.items()},
                    "heat": dict(self.state.heat)}}
        if op == "tablet_heat" and "alerts" in req:
            # strip the piggybacked firing-alert summary BEFORE the
            # propose: alert state is leader-local observability
            # (recomputed within one report interval after a leader
            # change), never replicated zero state
            node = str(req.get("alerts_node") or "?")
            with self.lock:
                self._node_report_mono[node] = time.monotonic()
                if req["alerts"]:
                    self._node_alerts[node] = {
                        "alerts": list(req["alerts"]),
                        "seen_mono": time.monotonic()}
                else:
                    self._node_alerts.pop(node, None)
            args = req.get("args", ())
            if not (args and args[0]):
                # pure status heartbeat (no tablets yet / no heat):
                # nothing to fold into the replicated heat EWMA —
                # record the report time, skip the raft propose
                return {"ok": True, "result": {}}
        if op in ("assign_ts", "read_ts", "assign_uids", "commit",
                  "txn_status", "abort_txn", "tablet", "bump_maxes",
                  "tablet_move_start", "tablet_move_done",
                  "tablet_move_abort", "move_request", "move_phase",
                  "tablet_size", "tablet_sizes", "tablet_heat",
                  "connect", "set_write_fence", "repl_phase"):
            with self.lock:
                if self.node.role != LEADER:
                    raise NotLeader(self.node.leader_id)
            ok, result = self.propose_and_wait(
                (op, req.get("args", ())))
            if not ok:
                return {"ok": False, "error": "no quorum"}
            return {"ok": True, "result": result}
        if op == "repl_status":
            # per-predicate replication lag (standby zero leader —
            # the driver's progress is leader-local observability)
            if self.repl is None:
                with self.lock:
                    return {"ok": True, "result": {
                        "phase": self.state.repl_phase,
                        "fence": self.state.write_fence,
                        "preds": {}}}
            out = self.repl.lag_payload()
            with self.lock:
                out["fence"] = self.state.write_fence
            return {"ok": True, "result": out}
        if op == "standby_promote":
            # measured-RPO/RTO failover: fence the primary, drain to
            # its post-fence CDC heads, flip this cluster writable
            if self.repl is None:
                return {"ok": False, "error":
                        "this zero is not a standby (--standby-of)"}
            with self.lock:
                if self.node.role != LEADER:
                    raise NotLeader(self.node.leader_id)
            from dgraph_tpu_torch.cluster.replication import PromoteError
            try:
                out = self.repl.promote(
                    force=bool(req.get("force", False)))
            except PromoteError as e:
                return {"ok": False, "error": str(e)}
            return {"ok": True, "result": out}
        if op == "hello":
            # same negotiation surface as alphas (storage/versions)
            from dgraph_tpu_torch.storage.versions import negotiate, \
                versions_payload
            out = versions_payload()
            out["negotiated"] = negotiate(
                int(req.get("protocol_version", 0)))
            return {"ok": True, "result": out}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _cluster_alerts(self) -> dict:
        """The leader-local aggregation of piggybacked alpha alerts
        (stale entries age out at 3 heat intervals: a dead node's
        last report must not look firing forever)."""
        ttl = 3 * 30.0
        try:
            import os as _os
            ttl = 3 * float(_os.environ.get(
                "DGRAPH_TPU_HEAT_INTERVAL_S", "") or 30.0)
        except ValueError:
            pass
        now = time.monotonic()
        with self.lock:
            for n in [n for n, rec in self._node_alerts.items()
                      if now - rec["seen_mono"] > ttl]:
                del self._node_alerts[n]
            return {n: {"alerts": list(rec["alerts"]),
                        "age_s": round(now - rec["seen_mono"], 1)}
                    for n, rec in sorted(self._node_alerts.items())}

    def _alerts_extra(self) -> dict:
        return {"cluster": self._cluster_alerts()}

    def watchdog_signals(self) -> dict:
        """Zero signals: base + the oldest move/split phase age (the
        move_stuck watchdog; ages come from the replicated ledger's
        phase_mono the leader's driver refreshes)."""
        out = super().watchdog_signals()
        now = time.monotonic()
        with self.lock:
            ages = [now - p["phase_mono"]
                    for p in self._move_progress.values()
                    if p.get("phase_mono") is not None]
            if self.node.role != LEADER:
                # alphas report to the LEADER only: a demoted zero's
                # stale report clock would age into a false fire —
                # drop it so a re-election starts a fresh one
                self._node_report_mono.clear()
            reports = [now - t
                       for t in self._node_report_mono.values()]
        if ages:
            out["move_stuck_age_s"] = max(ages)
        if reports:
            # the quietest alpha's report gap — the node-down /
            # partitioned-from-zero signal (works at replicas=1,
            # where raft_peer_silent has no peers to time)
            out["report_silent_s"] = max(reports)
        return out

    def debug_stats_payload(self) -> dict:
        """Zero's /debug/stats: base payload + the live move ledger
        enriched with the leader's driver progress (bytes streamed,
        catch-up lag, fence clock) and the heat table — what the dgtop
        MOVES panel renders."""
        from dgraph_tpu_torch.storage.versions import versions_payload
        out = super().debug_stats_payload()
        out["versions"] = versions_payload()
        with self.lock:
            moves = {p: dict(m) for p, m
                     in self.state.move_queue.items()}
            out["splits"] = {p: dict(s) for p, s
                             in self.state.splits.items()}
            out["heat"] = dict(self.state.heat)
            out["tablets_map"] = dict(self.state.tablets)
            role = self.node.role
            prog_snap = {p: dict(m)
                         for p, m in self._move_progress.items()}
        for pred, mv in moves.items():
            prog = prog_snap.get(pred) or {}
            mv["bytes"] = prog.get("bytes", 0)
            mv["lag"] = prog.get("lag")
            mv["fence_ms"] = prog.get("fence_ms")
            if prog.get("fence_started") is not None \
                    and mv["fence_ms"] is None:
                mv["fence_ms"] = round(
                    (time.monotonic() - prog["fence_started"]) * 1e3, 1)
        out["moves"] = moves
        out["role"] = role
        with self.lock:
            phase = self.state.repl_phase
            fence = self.state.write_fence
        if self.repl is not None:
            out["replication"] = self.repl.lag_payload()
            out["replication"]["fence"] = fence
        elif phase or fence:
            # a fenced/promoted cluster without a driver (an old
            # primary after failover) still surfaces its role
            out["replication"] = {"phase": phase, "fence": fence,
                                  "preds": {}}
        return out
