"""Zero state machine: replicated timestamps, uid leases, conflict
oracle and tablet map.

The reference's Zero keeps this state behind its own Raft quorum
(dgraph/cmd/zero/raft.go:619 applyProposal, assign.go:64 lease blocks,
oracle.go commit decisions, tablet.go:62 tablet claims). ZeroState is
that state machine extracted: every command is deterministic, so each
quorum member applies it identically and the proposer reads its local
apply result — no leader-only state.

Commands (payload = (op, args)):
  ("assign_ts",  (n,))                -> first ts of a block of n
  ("assign_uids",(n,))                -> first uid of a lease of n
  ("commit",     (start_ts, keys))    -> commit_ts, or 0 = conflict abort
                                         (idempotent: a decided txn
                                         returns its recorded outcome)
  ("txn_status", (start_ts,))         -> {"decided": bool, "commit_ts": n}
                                         — 2PC participants recover a
                                         crashed coordinator's decision
                                         (ref zero/oracle.go delta
                                         stream to alphas)
  ("abort_txn",  (start_ts,))         -> final decision for start_ts:
                                         records an abort unless the
                                         txn already committed (safe
                                         eviction of stale stages)
  ("tablet",     (pred, group))       -> owning group id (first claim wins)
  ("tablet_move_start", (pred, dst))  -> True once the tablet is marked
                                         read-only for the move
                                         (legacy one-shot path)
  ("move_request", (pred, dst[, nshards, shard]))
                                      -> enqueue a live move (or a
                                         hash-range split of `shard`)
                                         for the leader's driver; NO
                                         write fence yet
  ("move_phase", (pred, dst, phase[, snap_ts]))
                                      -> persist one phase transition
                                         (snapshotting -> catching_up
                                         -> fenced -> flipped); the
                                         fence entry/exit sets/clears
                                         the moving mark
  ("tablet_move_done", (pred, dst))   -> flips ownership + clears the
                                         moving mark (zero/tablet.go:62)
  ("tablet_size", (pred, bytes))      -> records a size report (the
                                         rebalancer's input,
                                         zero/tablet.go:180)
  ("tablet_heat", ({pred: (bytes, touches_delta)},))
                                      -> size + heat-EWMA report (the
                                         heat-driven rebalancer's load
                                         signal)
  ("connect", (key, want_group, raft_addr, client_addr, replicas))
                                      -> group assignment for a
                                         (re)connecting alpha: joins
                                         the least-replicated group
                                         under the replica target, or
                                         founds a new one
                                         (zero/zero.go:410 Connect)
  ("set_write_fence", (on,))          -> the CLUSTER-WIDE client-write
                                         fence (async replication:
                                         standbys boot fenced; a
                                         promotion fences the old
                                         primary). Replication applies
                                         bypass it — they land through
                                         the replicated-record path,
                                         not the ownership check.
  ("repl_phase", (phase,))            -> replication role transition:
                                         "" (normal primary) ->
                                         "standby" -> "promoting" ->
                                         "promoted" (now primary)

Port of `dgraph_tpu/cluster/zero.py`: a copy, its imports pointed at
this package.
"""

from __future__ import annotations

from typing import Any


class ZeroState:
    def __init__(self):
        self.max_ts = 0
        self.next_uid = 1
        # conflict window: key fingerprint -> last commit_ts
        # (zero/oracle.go commits map)
        self.commits: dict[int, int] = {}
        self.commits_floor = 0
        # decided transactions: start_ts -> commit_ts (0 = aborted).
        # The 2PC decision record: participants and retrying
        # coordinators read the outcome here instead of re-deciding.
        # decided_floor marks the trim horizon — status of anything
        # below it is unknowable (participants keep such stages
        # pending rather than guess)
        self.decided: dict[int, int] = {}
        self.decided_floor = 0
        self.tablets: dict[str, int] = {}
        self.moving: dict[str, int] = {}   # pred -> destination group
        # zero-owned move ledger (ref zero/tablet.go:62 movetablet —
        # the LEADER drives moves; the replicated phase machine lets a
        # new leader resume or roll back an in-flight move from the
        # exact phase it died in):
        #   pred -> {"dst": group, "src": group,
        #            "phase": "snapshotting" | "catching_up" |
        #                     "fenced" | "flipped",
        #            "snap_ts": int,                # catch-up base
        #            "nshards": int, "shard": int|None}  # split moves
        # Writes fence ONLY in "fenced" (self.moving set on entry,
        # cleared on flip/unfence/abort); reads never fence.
        self.move_queue: dict[str, dict] = {}
        # hash-range split registry: pred -> {"owners": [group per
        # shard]} — shard i of an n-way split (n = len(owners)) serves
        # subjects with shard_of(uid, n) == i (cluster/shard.py)
        self.splits: dict[str, dict] = {}
        self.sizes: dict[str, int] = {}    # pred -> reported bytes
        # per-tablet heat: EWMA of the alphas' reported query-path
        # touch DELTAS (storage/tabstats.py `touches`) — the
        # rebalancer's load signal (applied through raft, so every
        # quorum member computes the identical value)
        self.heat: dict[str, float] = {}
        # alpha registry: key (raft "host:port") -> member record
        # (zero/zero.go membership state)
        self.alphas: dict[str, dict] = {}
        # cross-cluster async replication (cluster/replication.py):
        # write_fence refuses ALL client writes cluster-wide (standby
        # clusters; a fenced old primary after promotion); repl_phase
        # is the replicated role so a new zero leader resumes the
        # standby loop — or stays promoted — exactly where the old
        # one died
        self.write_fence = False
        self.repl_phase = ""

    # ------------------------------------------------------------- apply

    def apply(self, cmd: tuple) -> Any:
        op, args = cmd
        if op == "assign_ts":
            (n,) = args
            first = self.max_ts + 1
            self.max_ts += int(n)
            return first
        if op == "read_ts":
            # non-bumping read grant for watermark-bounded follower
            # reads: every FUTURE commit_ts is > max_ts by
            # construction, so the snapshot at max_ts is final — a
            # replica whose applied watermark reaches it can serve the
            # read without waiting for a commit that will never come
            # (a fresh assign_ts here would stall idle clusters: no
            # commit ever lands ON a read-only allocation)
            return self.max_ts
        if op == "assign_uids":
            (n,) = args
            first = self.next_uid
            self.next_uid += int(n)
            return first
        if op == "commit":
            start_ts, keys = args
            start_ts = int(start_ts)
            if start_ts in self.decided:  # retry of a decided txn
                return self.decided[start_ts]
            if start_ts < self.commits_floor:
                # the conflict entries this txn would have to check
                # against may have been trimmed: conservative ABORT
                # (the reference oracle likewise rejects txns older
                # than its purge point) — committing could silently
                # miss a write-write conflict
                self.decided[start_ts] = 0
                return 0
            for k in keys:
                if self.commits.get(int(k), 0) > start_ts:
                    self.decided[start_ts] = 0
                    return 0  # write-write conflict: abort
            self.max_ts += 1
            commit_ts = self.max_ts
            for k in keys:
                self.commits[int(k)] = commit_ts
            self.decided[start_ts] = commit_ts
            self._trim_decided()
            self._trim_commits()
            return commit_ts
        if op == "txn_status":
            (start_ts,) = args
            got = self.decided.get(int(start_ts))
            return {"decided": got is not None,
                    "commit_ts": got or 0,
                    # participants must treat ts below the trim floor
                    # as unknowable, never as implicitly aborted
                    "floor": self.decided_floor}
        if op == "abort_txn":
            (start_ts,) = args
            return self.decided.setdefault(int(start_ts), 0)
        if op == "tablet":
            pred, group = args
            if pred in self.splits:
                # a split predicate has no single owner: claiming it
                # whole would shadow the range routing. -1 = "routed
                # per shard" (no group passes an ownership check).
                return -1
            return self.tablets.setdefault(pred, int(group))
        if op == "bump_maxes":
            # bulk-booted alphas push their snapshot watermarks so
            # zero never leases a ts/uid below pre-loaded data (ref
            # bulk/loader.go:88 leasing from zero + zero/assign.go)
            max_ts, next_uid = args
            self.max_ts = max(self.max_ts, int(max_ts))
            self.next_uid = max(self.next_uid, int(next_uid))
            return {"max_ts": self.max_ts, "next_uid": self.next_uid}
        if op == "tablet_move_start":
            pred, dst = args
            if pred not in self.tablets or \
                    self.tablets[pred] == int(dst) or pred in self.moving:
                return False
            self.moving[pred] = int(dst)
            return True
        if op == "move_request":
            # zero-owned move: enqueues for the leader's driver thread
            # (serialized: one ledger entry per pred; concurrent movers
            # get False back). Writes are NOT fenced here — the source
            # keeps serving reads AND writes through snapshotting and
            # catch-up; the fence is the short "fenced" phase only.
            # args = (pred, dst) for a whole-tablet move, or
            # (pred, dst, nshards, shard) to split `shard` of an n-way
            # hash-range split onto dst.
            pred, dst = args[0], int(args[1])
            nshards = int(args[2]) if len(args) > 2 else 1
            shard = int(args[3]) if len(args) > 3 and \
                args[3] is not None else None
            if pred not in self.tablets or pred in self.moving \
                    or pred in self.move_queue or pred in self.splits:
                return False
            if self.tablets[pred] == dst:
                return False  # no-op move; a split NEEDS another group
            if shard is not None and not (0 <= shard < nshards
                                          and nshards > 1):
                return False
            # src is captured HERE: after the flip the tablet map
            # points at dst, and the driver still owes the drop/prune
            # on the ORIGINAL owner (a resumed leader must not lose it)
            self.move_queue[pred] = {
                "dst": dst, "src": self.tablets[pred],
                "phase": "snapshotting", "snap_ts": 0,
                "nshards": nshards, "shard": shard}
            return True
        if op == "move_phase":
            # one phase transition of the ledger's machine, persisted
            # through raft so a new zero leader resumes exactly here:
            #   snapshotting -> catching_up   (snapshot installed)
            #   catching_up  -> fenced        (lag under bound; SETS
            #                                  the single-predicate
            #                                  write fence)
            #   fenced       -> catching_up   (fence drain timed out:
            #                                  UNFENCE, writes resume)
            #   catching_up  -> snapshotting  (CDC floor overtook the
            #                                  base: re-snapshot)
            pred, dst, phase = args[0], int(args[1]), args[2]
            snap_ts = int(args[3]) if len(args) > 3 else 0
            mv = self.move_queue.get(pred)
            if mv is None or mv["dst"] != dst:
                return False
            legal = {("snapshotting", "catching_up"),
                     ("catching_up", "fenced"),
                     ("fenced", "catching_up"),
                     ("catching_up", "snapshotting"),
                     # a fence-drain discovering the destination lost
                     # its copy / the log truncated restarts from a
                     # fresh snapshot (and UNFENCES via the phase
                     # exit below) — without this edge the driver
                     # would wedge fenced forever
                     ("fenced", "snapshotting"),
                     # legacy pre-phase-machine ledger entries drive
                     # through the streaming path too
                     ("start", "catching_up"),
                     ("start", "snapshotting")}
            if (mv["phase"], phase) not in legal:
                return False
            mv["phase"] = phase
            if snap_ts:
                mv["snap_ts"] = snap_ts
            if phase == "fenced":
                self.moving[pred] = dst
            else:
                self.moving.pop(pred, None)
            return True
        if op == "tablet_move_done":
            pred, dst = args
            if self.moving.get(pred) != int(dst):
                return False
            mv = self.move_queue.get(pred)
            if mv is not None and mv.get("shard") is not None:
                # split flip: the predicate becomes an n-way hash-range
                # split — the moved shard serves from dst, every other
                # shard stays with the source (cluster/shard.py routing)
                owners = [mv["src"]] * int(mv["nshards"])
                owners[int(mv["shard"])] = int(dst)
                self.splits[pred] = {"owners": owners}
                self.tablets.pop(pred, None)
            else:
                self.tablets[pred] = int(dst)
            del self.moving[pred]
            if mv is not None:
                # ownership flipped; the driver still owes the source
                # drop/prune — keep the ledger entry so a NEW leader
                # redoes it after a crash (both are idempotent)
                mv["phase"] = "flipped"
            return True
        if op == "tablet_move_abort":
            pred, dst = args
            if pred not in self.move_queue \
                    or self.move_queue[pred]["dst"] != int(dst):
                return False
            if self.move_queue[pred]["phase"] == "flipped":
                # post-flip the DESTINATION owns the only routed copy:
                # aborting now could only orphan or delete owned data
                # — the driver finishes the source drop instead
                return False
            self.moving.pop(pred, None)  # unfence if fenced
            self.move_queue.pop(pred, None)
            return True
        if op == "move_finish":
            (pred,) = args
            self.move_queue.pop(pred, None)
            return True
        if op == "tablet_size":
            pred, nbytes = args
            self.sizes[pred] = int(nbytes)
            return True
        if op == "tablet_sizes":
            (batch,) = args
            for pred, nbytes in batch.items():
                self.sizes[pred] = int(nbytes)
            return True
        if op == "tablet_heat":
            # one leader's periodic report: {pred: (bytes,
            # touches_delta)} — touch deltas since ITS last report.
            # Heat folds as an EWMA (identical on every quorum member:
            # the fold runs at raft apply); decay-on-report keeps a
            # cooled tablet's heat falling even when its group reports
            # zero deltas.
            (batch,) = args
            for pred, (nbytes, dt) in batch.items():
                # a SPLIT predicate's owners each report only their
                # shard's bytes/touches: scale to a whole-predicate
                # estimate before folding, or the shared EWMA would
                # converge to a per-shard value and the planner would
                # undercount split load ~owners-fold (piling more
                # tablets onto the groups the split was relieving)
                scale = len(self.splits[pred]["owners"]) \
                    if pred in self.splits else 1
                self.sizes[pred] = int(nbytes) * scale
                self.heat[pred] = round(
                    0.5 * self.heat.get(pred, 0.0)
                    + 0.5 * float(dt) * scale, 3)
            return True
        if op == "set_write_fence":
            (on,) = args
            self.write_fence = bool(on)
            return self.write_fence
        if op == "repl_phase":
            (phase,) = args
            if phase not in ("", "standby", "promoting", "promoted"):
                return False
            self.repl_phase = str(phase)
            return True
        if op == "connect":
            key, want_group, want_id, raft_addr, client_addr, \
                replicas = args[:6]
            # 7th arg (optional, newer alphas): non-voting learner —
            # registered for routing/membership but excluded from
            # replica-count placement, so a read replica never
            # satisfies a group's WRITE-quorum replica target
            learner = bool(args[6]) if len(args) > 6 else False
            prev = self.alphas.get(key)
            if prev is not None:
                # idempotent reconnect (restart at the same addr):
                # same assignment back, addresses refreshed from args
                gid = prev["group"]
                prev["raft"] = tuple(raft_addr)
                prev["client"] = tuple(client_addr)
                if learner:
                    prev["learner"] = True
            else:
                counts: dict[int, int] = {}
                for rec in self.alphas.values():
                    if rec.get("learner"):
                        continue  # learners don't count as replicas
                    counts[rec["group"]] = counts.get(rec["group"], 0) + 1
                gid = int(want_group)
                if gid <= 0:
                    # least-replicated group under the target, else a
                    # fresh group (zero.go:410-560 replica-count join).
                    # A learner joins the least-LOADED existing group
                    # instead of founding one: a group of only
                    # learners could never elect a leader.
                    if learner and counts:
                        under = sorted((n, g)
                                       for g, n in counts.items())
                        gid = under[0][1]
                    else:
                        under = [(n, g)
                                 for g, n in sorted(counts.items())
                                 if n < int(replicas)]
                        gid = min(under)[1] if under else \
                            (max(counts) + 1 if counts else 1)
                if int(want_id) > 0:
                    # explicit-group member registering its REAL raft
                    # id: a record in this group with the same id but
                    # a different key is a ghost of this node's
                    # previous incarnation (restarted on new ports) —
                    # replace it, never invent a new id
                    nid = int(want_id)
                    for k, rec in list(self.alphas.items()):
                        if rec["group"] == gid and rec["id"] == nid:
                            del self.alphas[k]
                else:
                    used = {rec["id"] for rec in self.alphas.values()
                            if rec["group"] == gid}
                    nid = max(used, default=0) + 1
                self.alphas[key] = {
                    "group": gid, "id": nid,
                    "raft": tuple(raft_addr),
                    "client": tuple(client_addr)}
                if learner:
                    self.alphas[key]["learner"] = True
            members = {rec["id"]: {"raft": rec["raft"],
                                   "client": rec["client"],
                                   "learner": bool(rec.get("learner"))}
                       for rec in self.alphas.values()
                       if rec["group"] == gid}
            return {"group": gid, "id": self.alphas[key]["id"],
                    "members": members}
        raise ValueError(f"unknown zero command {op!r}")

    def _trim_commits(self):
        """Bound the conflict window the same way: an entry only
        matters while a txn with start_ts below its commit_ts can
        still try to commit, and anything 10M ts behind max_ts is far
        past every stage TTL. Skipped while nothing is trimmable so
        commits never pay an O(window) rebuild for free."""
        if len(self.commits) > 131072:
            floor = self.max_ts - 10_000_000
            if floor - self.commits_floor < 1_000_000:
                # rebuild only when the floor has advanced a real
                # stride — with >131k live in-window keys an every-
                # commit rebuild would evict ~nothing at O(window) cost
                return
            self.commits = {k: v for k, v in self.commits.items()
                            if v >= floor}
            self.commits_floor = floor

    def _trim_decided(self):
        """Bound the decision registry: deterministic trim (applied
        identically on every quorum member) keeping a generous window
        behind max_ts. The 10M-ts window dwarfs the participants' 300s
        stage TTL unless zero sustains >33k ts-ops/s while a
        participant stays partitioned the whole time; even then the
        recorded floor makes participants keep (not mis-abort) stages
        whose decision was trimmed."""
        if len(self.decided) > 131072:
            floor = self.max_ts - 10_000_000
            if floor - self.decided_floor < 1_000_000:
                # rebuild only when the floor has advanced a real
                # stride — an every-commit rebuild over >131k retained
                # decisions would evict ~nothing at O(window) cost.
                # Growth stays bounded by ts volume between strides.
                return
            self.decided = {ts: c for ts, c in self.decided.items()
                            if ts >= floor}
            self.decided_floor = floor

    # --------------------------------------------------------- snapshots

    def snapshot(self) -> dict:
        return {"max_ts": self.max_ts, "next_uid": self.next_uid,
                "commits": dict(self.commits),
                "decided": dict(self.decided),
                "decided_floor": self.decided_floor,
                "commits_floor": self.commits_floor,
                "tablets": dict(self.tablets),
                "moving": dict(self.moving),
                "move_queue": {k: dict(v)
                               for k, v in self.move_queue.items()},
                "splits": {k: dict(v) for k, v in self.splits.items()},
                "sizes": dict(self.sizes),
                "heat": dict(self.heat),
                "write_fence": self.write_fence,
                "repl_phase": self.repl_phase,
                "alphas": {k: dict(v) for k, v in self.alphas.items()}}

    @classmethod
    def from_snapshot(cls, snap: dict) -> "ZeroState":
        st = cls()
        st.max_ts = snap["max_ts"]
        st.next_uid = snap["next_uid"]
        st.commits = dict(snap["commits"])
        st.decided = dict(snap.get("decided", {}))
        st.decided_floor = snap.get("decided_floor", 0)
        st.commits_floor = snap.get("commits_floor", 0)
        st.tablets = dict(snap["tablets"])
        st.moving = dict(snap.get("moving", {}))
        st.move_queue = {k: dict(v) for k, v
                         in snap.get("move_queue", {}).items()}
        st.splits = {k: dict(v)
                     for k, v in snap.get("splits", {}).items()}
        st.sizes = dict(snap.get("sizes", {}))
        st.heat = dict(snap.get("heat", {}))
        st.write_fence = bool(snap.get("write_fence", False))
        st.repl_phase = str(snap.get("repl_phase", ""))
        st.alphas = {k: dict(v)
                     for k, v in snap.get("alphas", {}).items()}
        return st
