"""Deterministic in-process Raft cluster harness.

The reference tests multi-node behavior with docker-compose topologies
plus Jepsen nemeses (SURVEY §4.5, §4.7: partition-ring, kill-alpha,
clock skew). Our equivalent is a simulated network: every node is a
tick-driven RaftNode, messages flow through a bus with per-link drop /
partition controls, and the scheduler pumps ticks deterministically —
the same failure scenarios run in milliseconds with a seeded RNG, no
containers.

Port of `dgraph_tpu/cluster/harness.py`: a copy, its imports pointed at
this package.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Optional

from dgraph_tpu_torch.cluster.raft import LEADER, Msg, RaftNode


class SimCluster:
    """N Raft nodes over a lossy, partitionable in-memory network."""

    def __init__(self, n: int, storage_factory: Optional[Callable] = None,
                 seed: int = 0, election_ticks: int = 10):
        self.ids = list(range(1, n + 1))
        self.rng = random.Random(seed)
        self.election_ticks = election_ticks
        self.storage_factory = storage_factory or (lambda node_id: None)
        self.nodes: dict[int, RaftNode] = {}
        self.applied: dict[int, list] = {i: [] for i in self.ids}
        self.inbox: list[Msg] = []
        self.cut: set[tuple[int, int]] = set()   # directed broken links
        self.down: set[int] = set()
        self.drop_rate = 0.0
        self.on_apply: Optional[Callable[[int, Any], None]] = None
        self.on_restore: Optional[Callable[[int, Any], None]] = None
        for i in self.ids:
            self._start(i)

    def _start(self, i: int):
        self.nodes[i] = RaftNode(
            i, self.ids, storage=self.storage_factory(i),
            election_ticks=self.election_ticks,
            rng=random.Random(self.rng.randrange(1 << 30)))

    # ----------------------------------------------------------- failures

    def partition(self, side_a: list[int], side_b: list[int]):
        for a in side_a:
            for b in side_b:
                self.cut.add((a, b))
                self.cut.add((b, a))

    def heal(self):
        self.cut.clear()

    def kill(self, i: int):
        self.down.add(i)
        self.inbox = [m for m in self.inbox if m.to != i and m.frm != i]

    def restart(self, i: int):
        """Node comes back from its persistent storage only."""
        self.down.discard(i)
        self._start(i)
        r = self.nodes[i].ready()
        if r.snapshot is not None and self.on_restore:
            self.on_restore(i, r.snapshot[2])

    # ------------------------------------------------------------ pumping

    def pump(self, ticks: int = 1):
        for _ in range(ticks):
            for i in self.ids:
                if i in self.down:
                    continue
                self.nodes[i].tick()
            self._drain()

    def _drain(self, rounds: int = 20):
        for _ in range(rounds):
            if not self.inbox:
                progressed = False
            else:
                progressed = True
                batch, self.inbox = self.inbox, []
                for m in batch:
                    if (m.frm, m.to) in self.cut or m.to in self.down \
                            or m.frm in self.down:
                        continue
                    if self.drop_rate and \
                            self.rng.random() < self.drop_rate:
                        continue
                    self.nodes[m.to].step(m)
            for i in self.ids:
                if i in self.down:
                    continue
                r = self.nodes[i].ready()
                self.inbox.extend(r.msgs)
                if r.snapshot is not None and self.on_restore:
                    self.on_restore(i, r.snapshot[2])
                for e in r.committed:
                    if e.data is not None:
                        self.applied[i].append(e.data)
                        if self.on_apply:
                            self.on_apply(i, e.data)
            if not progressed and not self.inbox:
                return

    # ------------------------------------------------------------- helpers

    def leader(self) -> Optional[int]:
        for i in self.ids:
            if i not in self.down and self.nodes[i].role == LEADER:
                return i
        return None

    def wait_leader(self, max_ticks: int = 200) -> int:
        for _ in range(max_ticks):
            lead = self.leader()
            if lead is not None:
                return lead
            self.pump()
        raise AssertionError("no leader elected")

    def propose(self, data: Any, retries: int = 50) -> bool:
        for _ in range(retries):
            lead = self.leader()
            if lead is not None and self.nodes[lead].propose(data):
                self._drain()
                return True
            self.pump()
        return False
