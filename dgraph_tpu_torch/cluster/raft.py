"""Raft consensus — replication for Alpha groups and the Zero quorum.

The reference replicates every shard ("group") and the Zero coordinator
through etcd's Raft library (worker/draft.go, dgraph/cmd/zero/raft.go,
conn/node.go glue, raftwal/storage.go persistence). This is our own
implementation of the same protocol, shaped like etcd's raft rather than
a thread-per-timer design: a `RaftNode` is a pure tick-driven state
machine — the container calls `tick()` on a logical clock, `step(msg)`
for inbound messages, `propose(data)` for client writes, and drains
`ready()` for (messages to send, entries to persist, entries to apply).
That makes elections, partitions, and crash-replay deterministic in
tests (no wall clock, no sleeps), mirroring how the reference's Run
loops pump etcd raft's Ready channel (worker/draft.go:760).

Persistence uses the host runtime's KV store (csrc/native.cc):
hardstate + log entries + snapshot survive restart the way
raftwal.DiskStorage persists to Badger (raftwal/storage.go:37).

Log compaction: `take_snapshot(data, index)` truncates the log below
`index` and stores an application snapshot; followers too far behind
receive InstallSnapshot (ref worker/snapshot.go:107 streamed snapshots,
raft.go MsgSnap path).

Port of `dgraph_tpu/cluster/raft.py`: a copy, its imports pointed at
this package. `DiskStorage` keeps its keys in `native.NativeKV`, and in
`storage/kvfallback.PyKV` when the runtime is switched off, so a raft
directory either package writes opens in the other.
"""

from __future__ import annotations

import random

from dgraph_tpu_torch.wire import dumps as wire_dumps
from dgraph_tpu_torch.wire import loads_compat as _wire_load

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

# message types
VOTE_REQ = "vote_req"
VOTE_RESP = "vote_resp"
APPEND_REQ = "append_req"
APPEND_RESP = "append_resp"
SNAP_REQ = "snap_req"
SNAP_RESP = "snap_resp"
GOODBYE = "goodbye"  # "you were conf-removed" notice to a non-member


@dataclass
class Entry:
    term: int
    index: int
    data: Any


@dataclass
class Msg:
    type: str
    frm: int
    to: int
    term: int
    # vote
    last_log_index: int = 0
    last_log_term: int = 0
    granted: bool = False
    # append
    prev_index: int = 0
    prev_term: int = 0
    entries: list = field(default_factory=list)
    commit: int = 0
    success: bool = False
    match_index: int = 0
    reject_hint: int = 0
    # snapshot
    snap_index: int = 0
    snap_term: int = 0
    snap_data: Any = None


@dataclass
class Ready:
    msgs: list
    committed: list          # entries newly safe to apply
    soft_state: tuple        # (role, leader_id)
    snapshot: Optional[tuple] = None  # (index, term, data) to restore


class MemoryStorage:
    """Volatile storage (tests); interface shared with DiskStorage."""

    def __init__(self):
        self.term = 0
        self.voted_for = None
        self.entries: list[Entry] = []
        self.snap_index = 0
        self.snap_term = 0
        self.snap_data = None

    def save_hardstate(self, term: int, voted_for: Optional[int]):
        self.term = term
        self.voted_for = voted_for

    def append(self, entries: list[Entry]):
        if entries:
            first = entries[0].index
            self.entries = [e for e in self.entries if e.index < first]
            self.entries.extend(entries)

    def save_snapshot(self, index: int, term: int, data: Any):
        self.snap_index = index
        self.snap_term = term
        self.snap_data = data
        self.entries = [e for e in self.entries if e.index > index]

    def save_members(self, members: dict):
        """Persist the conf-changed membership map so a restart keeps
        it instead of reverting to the CLI's --raft-peers (volatile
        storage: no-op)."""

    def load_members(self) -> Optional[dict]:
        return None

    def flush(self):
        pass

    def close(self):
        pass


class DiskStorage(MemoryStorage):
    """Raft persistence over the native KV store (the raftwal role:
    raftwal/storage.go keys entry/hardstate/snapshot per node)."""

    def __init__(self, directory: str, sync: bool = False):
        super().__init__()
        from dgraph_tpu_torch import native
        if native.available():
            self._kv = native.NativeKV(directory, sync)
        else:
            from dgraph_tpu_torch.storage.kvfallback import PyKV
            self._kv = PyKV(directory, sync)
        hs = self._kv.get(b"hs")
        if hs is not None:
            self.term, self.voted_for = _wire_load(hs)
        sn = self._kv.get(b"snap")
        if sn is not None:
            self.snap_index, self.snap_term, self.snap_data = \
                _wire_load(sn)
        for k, v in self._kv.scan(b"e/"):
            e = _wire_load(v)
            if e.index > self.snap_index:
                self.entries.append(e)
        self.entries.sort(key=lambda e: e.index)

    def save_hardstate(self, term, voted_for):
        super().save_hardstate(term, voted_for)
        self._kv.put(b"hs", wire_dumps((term, voted_for)))

    def append(self, entries):
        if not entries:
            return
        prev_last = self.entries[-1].index if self.entries \
            else self.snap_index
        super().append(entries)
        for e in entries:
            self._kv.put(b"e/%016x" % e.index, wire_dumps(e))
        # conflict truncation shrank the log: stale persisted entries
        # above the new tail must go too, or a restart resurrects a
        # deposed leader's discarded suffix
        for idx in range(entries[-1].index + 1, prev_last + 1):
            self._kv.delete(b"e/%016x" % idx)

    def save_snapshot(self, index, term, data):
        # persist the snapshot record FIRST: a crash between the two
        # steps must never leave neither entries nor snapshot (recovery
        # skips log keys <= snap_index anyway)
        self._kv.put(b"snap", wire_dumps((index, term, data)))
        # then drop log keys below it, like raftwal truncation
        # (raftwal/storage.go:594 CreateSnapshot)
        for k, _ in list(self._kv.scan(b"e/")):
            if int(k[2:], 16) <= index:
                self._kv.delete(k)
        super().save_snapshot(index, term, data)
        if hasattr(self._kv, "snapshot"):
            self._kv.snapshot()

    def save_members(self, members: dict):
        self._kv.put(b"members", wire_dumps(members))

    def load_members(self) -> Optional[dict]:
        raw = self._kv.get(b"members")
        return _wire_load(raw) if raw is not None else None

    def flush(self):
        if hasattr(self._kv, "flush"):
            self._kv.flush()

    def close(self):
        # Users of the handle: the raft steps of a RaftServer (its tick
        # loop, the transport's inbound messages, client proposes), all
        # under the server's lock. RaftServer.close waits out the step
        # in flight and stops later ones, so the owner closes this
        # after the server; a call that still arrives raises the
        # store's ClosedError (native store) into that step's thread.
        self._kv.close()


class RaftNode:
    """One member of a Raft group. Pure state machine, no IO."""

    def __init__(self, node_id: int, peers: list[int],
                 storage: Optional[MemoryStorage] = None,
                 election_ticks: int = 10, heartbeat_ticks: int = 2,
                 rng: Optional[random.Random] = None,
                 max_batch: int = 64, learner: bool = False):
        self.id = node_id
        self.peers = [p for p in peers if p != node_id]
        # Non-voting members (etcd raft "learners", ref raft.go
        # ProgressTracker.Learners): they receive the replicated log but
        # never campaign, vote, or count toward the commit quorum.
        self.learners: set[int] = set()
        self.learner = learner
        self.storage = storage or MemoryStorage()
        self.rng = rng or random.Random(node_id * 7919)
        self.election_ticks = election_ticks
        self.heartbeat_ticks = heartbeat_ticks
        self.max_batch = max_batch

        self.term = self.storage.term
        self.voted_for = self.storage.voted_for
        self.log: list[Entry] = list(self.storage.entries)
        self.snap_index = self.storage.snap_index
        self.snap_term = self.storage.snap_term

        self.role = FOLLOWER
        self.leader_id: Optional[int] = None
        self.removed = False  # this node was conf-removed: stop
        #                       campaigning/heartbeating, serve reads only
        self.commit_index = self.snap_index
        self.applied_index = self.snap_index
        self.votes: set[int] = set()
        self.next_index: dict[int, int] = {}
        self.match_index: dict[int, int] = {}
        self.elapsed = 0
        self.timeout = self._rand_timeout()

        self._msgs: list[Msg] = []
        self._pending_snapshot: Optional[tuple] = None
        # restore-from-disk: surface the persisted snapshot to the app
        if self.storage.snap_data is not None:
            self._pending_snapshot = (self.snap_index, self.snap_term,
                                      self.storage.snap_data)

    # ---------------------------------------------------------------- log

    def _rand_timeout(self) -> int:
        return self.election_ticks + self.rng.randrange(self.election_ticks)

    def last_index(self) -> int:
        return self.log[-1].index if self.log else self.snap_index

    def last_term(self) -> int:
        return self.log[-1].term if self.log else self.snap_term

    def _entry(self, index: int) -> Optional[Entry]:
        off = index - self.snap_index - 1
        if 0 <= off < len(self.log):
            return self.log[off]
        return None

    def _term_at(self, index: int) -> Optional[int]:
        if index == self.snap_index:
            return self.snap_term
        e = self._entry(index)
        return e.term if e else None

    # ------------------------------------------------------------- driving

    def tick(self):
        if self.removed:
            return
        self.elapsed += 1
        if self.role == LEADER:
            if self.elapsed >= self.heartbeat_ticks:
                self.elapsed = 0
                self._broadcast_append()
        elif self.elapsed >= self.timeout:
            if self.learner:
                # learners never campaign; a silent leader just means
                # we wait for the next append
                self.elapsed = 0
            else:
                self._campaign()

    def propose(self, data: Any) -> bool:
        """Leader-only append; returns False when not leader (caller
        forwards to leader_id, ref worker/proposal.go routing)."""
        if self.role != LEADER:
            return False
        e = Entry(self.term, self.last_index() + 1, data)
        self.log.append(e)
        self.storage.append([e])
        self.match_index[self.id] = e.index
        if not self.peers:  # single-voter group commits immediately
            self._advance_commit()
        if self.peers or self.learners:
            self._broadcast_append()
        return True

    def step(self, m: Msg):
        if m.term > self.term:
            self._become_follower(m.term,
                                  m.frm if m.type == APPEND_REQ else None)
        handler = {
            VOTE_REQ: self._on_vote_req,
            VOTE_RESP: self._on_vote_resp,
            APPEND_REQ: self._on_append_req,
            APPEND_RESP: self._on_append_resp,
            SNAP_REQ: self._on_snap_req,
            SNAP_RESP: self._on_snap_resp,
        }[m.type]
        handler(m)

    def ready(self) -> Ready:
        msgs, self._msgs = self._msgs, []
        committed = []
        while self.applied_index < self.commit_index:
            self.applied_index += 1
            e = self._entry(self.applied_index)
            if e is not None:
                committed.append(e)
        snap, self._pending_snapshot = self._pending_snapshot, None
        if snap is not None:
            self.applied_index = max(self.applied_index, snap[0])
        return Ready(msgs, committed, (self.role, self.leader_id), snap)

    def take_snapshot(self, data: Any, index: Optional[int] = None):
        """App-driven checkpoint: compact the log below `index`
        (defaults to applied). Ref worker/draft.go:1206
        calculateSnapshot + raftwal truncation."""
        index = self.applied_index if index is None else index
        if index <= self.snap_index:
            return
        term = self._term_at(index)
        self.storage.save_snapshot(index, term, data)
        self.log = [e for e in self.log if e.index > index]
        self.snap_index = index
        self.snap_term = term

    # -------------------------------------------------- membership changes
    # Applied at COMMIT time, one change in flight at a time (the etcd
    # model; ref conn.Node conf changes + zero/raft.go member proposals).

    def add_peer(self, p: int):
        if p == self.id:
            self.learner = False  # promotion to voter
            return
        if p in self.peers:
            return
        promoted = p in self.learners
        self.learners.discard(p)
        self.peers.append(p)
        if self.role == LEADER:
            if not promoted:  # a promoted learner keeps its progress
                self.next_index[p] = self.last_index() + 1
                self.match_index[p] = 0
                self._send_append(p)
            self._advance_commit()  # the quorum just grew

    def add_learner(self, p: int):
        """Add a non-voting member: replicated to, never counted."""
        if p == self.id:
            self.learner = True
            return
        if p in self.peers or p in self.learners:
            return
        self.learners.add(p)
        if self.role == LEADER:
            self.next_index[p] = self.last_index() + 1
            self.match_index[p] = 0
            self._send_append(p)

    def remove_peer(self, p: int):
        if p == self.id:
            # self-removal: step down and go quiet; the rest of the
            # cluster stops heartbeating us (ref /removeNode semantics)
            self.removed = True
            if self.role == LEADER:
                self.role = FOLLOWER
                self.leader_id = None
            return
        if p in self.peers:
            self.peers.remove(p)
        self.learners.discard(p)
        self.next_index.pop(p, None)
        self.match_index.pop(p, None)
        self.votes.discard(p)
        if self.role == LEADER:
            self._advance_commit()  # the quorum just shrank

    # ------------------------------------------------------------ internal

    def _become_follower(self, term: int, leader: Optional[int]):
        if term > self.term:
            # votes are per-term: a term bump always clears ours,
            # whatever triggered it (vote req or append from new leader)
            self.voted_for = None
        self.term = term
        self.role = FOLLOWER
        self.leader_id = leader
        self.votes = set()
        self.elapsed = 0
        self.timeout = self._rand_timeout()
        self.storage.save_hardstate(self.term, self.voted_for)

    def _campaign(self):
        self.term += 1
        self.role = CANDIDATE
        self.voted_for = self.id
        self.leader_id = None
        self.votes = {self.id}
        self.elapsed = 0
        self.timeout = self._rand_timeout()
        self.storage.save_hardstate(self.term, self.voted_for)
        if not self.peers:
            self._become_leader()
            return
        for p in self.peers:
            self._msgs.append(Msg(VOTE_REQ, self.id, p, self.term,
                                  last_log_index=self.last_index(),
                                  last_log_term=self.last_term()))

    def _become_leader(self):
        self.role = LEADER
        self.leader_id = self.id
        reps = self._replicas()
        self.next_index = {p: self.last_index() + 1 for p in reps}
        self.match_index = {p: 0 for p in reps}
        self.match_index[self.id] = self.last_index()
        # noop entry to commit entries from prior terms (§5.4.2)
        e = Entry(self.term, self.last_index() + 1, None)
        self.log.append(e)
        self.storage.append([e])
        self.match_index[self.id] = e.index
        if not self.peers:
            self._advance_commit()
        if reps:
            self._broadcast_append()

    def _on_vote_req(self, m: Msg):
        up_to_date = (m.last_log_term, m.last_log_index) >= \
            (self.last_term(), self.last_index())
        grant = (m.term >= self.term and up_to_date
                 and self.voted_for in (None, m.frm)
                 and self.role != LEADER
                 and not self.learner)  # learners never vote
        if grant:
            self.voted_for = m.frm
            self.elapsed = 0
            self.storage.save_hardstate(self.term, self.voted_for)
        self._msgs.append(Msg(VOTE_RESP, self.id, m.frm, self.term,
                              granted=grant))

    def _on_vote_resp(self, m: Msg):
        if self.role != CANDIDATE or m.term < self.term:
            return
        # only votes from the CURRENT configuration count toward the
        # quorum — a stale ex-member's grant must never let two
        # candidates both reach "majority" in one term
        if m.granted and (m.frm in self.peers or m.frm == self.id):
            self.votes.add(m.frm)
            if len(self.votes) * 2 > len(self.peers) + 1:
                self._become_leader()

    def _replicas(self) -> list[int]:
        """Everyone the leader replicates to: voters + learners."""
        return list(self.peers) + sorted(self.learners)

    def _broadcast_append(self):
        for p in self._replicas():
            self._send_append(p)

    def _send_append(self, p: int):
        nxt = self.next_index.get(p, self.last_index() + 1)
        if nxt <= self.snap_index:
            # follower needs state we compacted away: ship the snapshot
            self._msgs.append(Msg(
                SNAP_REQ, self.id, p, self.term,
                snap_index=self.snap_index, snap_term=self.snap_term,
                snap_data=self.storage.snap_data, commit=self.commit_index))
            return
        prev = nxt - 1
        prev_term = self._term_at(prev)
        if prev_term is None:
            prev_term = 0
        off = nxt - self.snap_index - 1  # log is contiguous from snap+1
        ents = self.log[off: off + self.max_batch]
        self._msgs.append(Msg(APPEND_REQ, self.id, p, self.term,
                              prev_index=prev, prev_term=prev_term,
                              entries=ents, commit=self.commit_index))

    def _on_append_req(self, m: Msg):
        if m.term < self.term:
            self._msgs.append(Msg(APPEND_RESP, self.id, m.frm, self.term,
                                  success=False))
            return
        self.role = FOLLOWER
        self.leader_id = m.frm
        self.elapsed = 0
        # a quiet joiner (started with removed=True while waiting for
        # its conf-change) wakes on the first append from the leader —
        # that message proves it is now a member. Genuinely removed
        # nodes never receive appends (they left every member's peers).
        self.removed = False
        local_prev_term = self._term_at(m.prev_index)
        if m.prev_index > self.last_index() or (
                local_prev_term is not None
                and local_prev_term != m.prev_term):
            hint = min(m.prev_index, self.last_index() + 1)
            self._msgs.append(Msg(APPEND_RESP, self.id, m.frm, self.term,
                                  success=False, reject_hint=hint))
            return
        if local_prev_term is None:
            # prev falls below our snapshot: entries <= snap_index are
            # already applied; accept the overlap from snap_index on
            m.entries = [e for e in m.entries if e.index > self.snap_index]
        new = []
        for e in m.entries:
            have = self._entry(e.index)
            if have is not None and have.term != e.term:
                self.log = [x for x in self.log if x.index < e.index]
                have = None
            if have is None:
                new.append(e)
        if new:
            self.log.extend(new)
            self.storage.append(new)
        if m.commit > self.commit_index:
            self.commit_index = min(m.commit, self.last_index())
        self._msgs.append(Msg(APPEND_RESP, self.id, m.frm, self.term,
                              success=True,
                              match_index=m.prev_index + len(m.entries)))

    def _on_append_resp(self, m: Msg):
        if self.role != LEADER or m.term < self.term:
            return
        if m.success:
            self.match_index[m.frm] = max(
                self.match_index.get(m.frm, 0), m.match_index)
            self.next_index[m.frm] = self.match_index[m.frm] + 1
            self._advance_commit()
            if self.next_index[m.frm] <= self.last_index():
                self._send_append(m.frm)  # keep streaming the backlog
        else:
            hint = m.reject_hint if m.reject_hint else \
                self.next_index.get(m.frm, 2) - 1
            self.next_index[m.frm] = max(1, hint)
            self._send_append(m.frm)

    def _advance_commit(self):
        """Commit = highest index replicated on a majority with an entry
        from the current term (§5.4.2)."""
        n_members = len(self.peers) + 1
        for idx in range(self.last_index(), self.commit_index, -1):
            if self._term_at(idx) != self.term:
                break
            # learners' progress must never inflate the quorum count
            count = sum(1 for p, mi in self.match_index.items()
                        if mi >= idx and (p == self.id or p in self.peers))
            if count * 2 > n_members:
                self.commit_index = idx
                break

    def _on_snap_req(self, m: Msg):
        if m.term < self.term:
            return
        self.role = FOLLOWER
        self.leader_id = m.frm
        self.elapsed = 0
        if m.snap_index <= self.snap_index:
            self._msgs.append(Msg(SNAP_RESP, self.id, m.frm, self.term,
                                  match_index=self.snap_index))
            return
        self.storage.save_snapshot(m.snap_index, m.snap_term, m.snap_data)
        self.log = []
        self.snap_index = m.snap_index
        self.snap_term = m.snap_term
        self.commit_index = max(self.commit_index, m.snap_index)
        self.applied_index = m.snap_index
        self._pending_snapshot = (m.snap_index, m.snap_term, m.snap_data)
        self._msgs.append(Msg(SNAP_RESP, self.id, m.frm, self.term,
                              match_index=m.snap_index))

    def _on_snap_resp(self, m: Msg):
        if self.role != LEADER:
            return
        self.match_index[m.frm] = max(self.match_index.get(m.frm, 0),
                                      m.match_index)
        self.next_index[m.frm] = self.match_index[m.frm] + 1
