"""Replicated engine group: GraphDB state machine over Raft.

The reference model (worker/draft.go): every Alpha group is a Raft
group; mutations are proposed to the group leader, replicated, then
applied by each member's apply loop. Here the proposal payload is
exactly the engine's durable WAL record (GraphDB.apply_record is shared
between WAL replay and the Raft apply path), so a follower's state
matches the leader's record-for-record.

Write path (ref worker/mutation.go:537 MutateOverNetwork →
proposal.go:113 proposeAndWait): the mutation executes on the leader
replica's engine — allocating uids/ts and producing the expanded commit
record via the engine's on_record sink — then the record is proposed to
the group. Followers apply it; the leader skips re-applying its own
records (its engine already holds the txn result). Origins carry a
per-process epoch so a restarted replica re-applies records it proposed
in a previous life (its rebuilt engine doesn't have them).

Reads go to any replica (followers serve snapshot reads like the
reference's best-effort queries, edgraph/server.go:760).

Snapshots: checkpoint() folds the engine state into a Raft snapshot
(storage.snapshot.dump_state) and compacts the log; a lagging or fresh
member is restored from it via InstallSnapshot (ref worker/snapshot.go
doStreamSnapshot/populateSnapshot).

The driver here is synchronous-deterministic (SimCluster); a network
transport swaps in at the Msg layer without touching this file.

Port of `dgraph_tpu/cluster/replica.py`: a copy, its imports pointed at
this package.
`ReplicatedGroup(**db_kw)` builds every replica's engine with
`db_kw`, so `device` rides there: None (the default) is the card,
raising without one; `device="cpu"` keeps the group on the host.
"""

from __future__ import annotations

import itertools
from typing import Any, Optional

from dgraph_tpu_torch import wire

from dgraph_tpu_torch.cluster.harness import SimCluster
from dgraph_tpu_torch.engine.db import GraphDB
from dgraph_tpu_torch.storage.snapshot import dump_state, restore_state


class ReplicatedGroup:
    """N-replica engine group over a simulated Raft transport."""

    def __init__(self, n: int = 3, seed: int = 0,
                 storage_factory=None, **db_kw):
        self.cluster = SimCluster(n, seed=seed,
                                  storage_factory=storage_factory)
        db_kw.setdefault("prefer_device", False)
        self._db_kw = db_kw
        self.dbs: dict[int, GraphDB] = {
            i: GraphDB(**db_kw) for i in self.cluster.ids}
        self._epoch: dict[int, int] = {i: 0 for i in self.cluster.ids}
        self._acked: dict[int, set] = {i: set() for i in self.cluster.ids}
        # committed event stream per node (snapshot resets + records):
        # the authoritative source to rebuild an engine whose local
        # pre-consensus apply turned out not to replicate
        self._events: dict[int, list] = {i: [] for i in self.cluster.ids}
        self._mark_seq = itertools.count(1)
        self.cluster.on_apply = self._apply
        self.cluster.on_restore = self._restore
        self.cluster.wait_leader()

    # ------------------------------------------------------------- apply

    def _apply(self, node_id: int, data: Any):
        mark, origin, rec = data
        self._acked[node_id].add(mark)
        self._events[node_id].append(("rec", rec))
        if origin == (node_id, self._epoch[node_id]):
            # the proposing replica already holds this state (its local
            # engine executed the txn); don't double-apply
            return
        db = self.dbs[node_id]
        ts = db.apply_record(rec)
        if ts:
            db.fast_forward_ts(ts)

    def _restore(self, node_id: int, snap: bytes):
        """InstallSnapshot: rebuild the replica's engine from the
        serialized state (ref worker/snapshot.go populateSnapshot)."""
        self._events[node_id] = [("snap", snap)]
        self.dbs[node_id] = restore_state(wire.loads_compat(snap),
                                          GraphDB(**self._db_kw))

    def _rebuild(self, node_id: int):
        """Discard a replica's un-replicated local state: rebuild its
        engine purely from the committed event stream. Used when a
        leader pre-applied a txn (for ts/uid allocation) whose record
        then failed to reach quorum — the Raft analogue of a deposed
        leader dropping its uncommitted tail."""
        self._epoch[node_id] += 1  # past own-origin records must re-apply
        db = GraphDB(**self._db_kw)
        for kind, payload in self._events[node_id]:
            if kind == "snap":
                db = restore_state(wire.loads_compat(payload), db)
            else:
                ts = db.apply_record(payload)
                if ts:
                    db.fast_forward_ts(ts)
        self.dbs[node_id] = db

    # ------------------------------------------------------------- writes

    def _propose_record(self, origin_id: int, rec) -> bool:
        mark = next(self._mark_seq)
        origin = (origin_id, self._epoch[origin_id])
        if not self.cluster.propose((mark, origin, rec)):
            return False
        for _ in range(200):  # wait until the origin's replica applied it
            if mark in self._acked[origin_id]:
                return True
            self.cluster.pump()
        return False

    def leader_id(self) -> int:
        lead = self.cluster.leader()
        if lead is None:
            lead = self.cluster.wait_leader()
        return lead

    def alter(self, schema_text: str = "", **kw):
        lead = self.leader_id()
        recs = self._run_with_sink(lead, lambda db: db.alter(
            schema_text, **kw))
        self._replicate(lead, recs, "alter")

    def mutate(self, **kw) -> dict:
        """Execute on the leader engine, replicate its commit record."""
        lead = self.leader_id()
        out: dict = {}

        def run(db):
            out.update(db.mutate(commit_now=True, **kw))

        recs = self._run_with_sink(lead, run)
        self._replicate(lead, recs, "mutation")
        return out

    def _replicate(self, lead: int, recs: list, what: str):
        for rec in recs:
            if not self._propose_record(lead, rec):
                # quorum unreachable: roll the pre-applied state back so
                # this replica never serves phantom data
                self._rebuild(lead)
                raise RuntimeError(f"{what} not replicated (no quorum)")

    def _run_with_sink(self, node_id: int, fn) -> list:
        db = self.dbs[node_id]
        captured: list = []
        prev = db.on_record
        db.on_record = captured.append
        try:
            fn(db)
        finally:
            db.on_record = prev
        return captured

    # ------------------------------------------------------------- reads

    def query(self, q: str, node: Optional[int] = None, **kw) -> dict:
        node = node if node is not None else self.leader_id()
        return self.dbs[node].query(q, **kw)

    # --------------------------------------------------------- snapshots

    def checkpoint(self, node: Optional[int] = None):
        """Compact the Raft log into an engine snapshot on `node`
        (default: leader). Ref worker/draft.go:1206 calculateSnapshot."""
        node = node if node is not None else self.leader_id()
        snap = wire.dumps(dump_state(self.dbs[node]))
        self.cluster.nodes[node].take_snapshot(snap)

    # ---------------------------------------------------------- failures

    def kill(self, node_id: int):
        self.cluster.kill(node_id)

    def restart(self, node_id: int):
        """Replica restarts with a fresh engine; its state is rebuilt
        from the Raft log (and/or snapshot) alone."""
        self.dbs[node_id] = GraphDB(**self._db_kw)
        self._epoch[node_id] += 1
        self._acked[node_id] = set()
        self._events[node_id] = []  # re-deliveries repopulate it
        self.cluster.restart(node_id)
        self.cluster.pump(5)

    def pump(self, n: int = 1):
        self.cluster.pump(n)
