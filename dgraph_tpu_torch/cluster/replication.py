"""Cross-cluster async replication: a standby cluster tails a primary.

The standby's zero LEADER runs a ReplicationDriver (the same posture
as the tablet-move driver in cluster/service.py): per primary tablet
it streams the base snapshot through the move export surface
(move_export_begin / move_chunk -> move_stage_chunk -> repl_install),
then tails the primary's raw change log (move_deltas — the
cdc/changelog.read_raw contract: whole commits, ascending ts) and
applies batches through the standby group's replicated move_delta
path. The standby tablet's durable max_commit_ts IS the resume point
after any crash on either side — no extra progress records, exactly
the mover's trick. A truncated change log (the bounded raw ring
evicted past our watermark) drops the standby copy and re-snapshots:
the same truncation -> resync contract subscribers get.

Roles are replicated state on the standby's zero (ZeroState.repl_phase
+ write_fence), so a NEW standby zero leader resumes tailing — or
stays promoted — exactly where the old one died. The fence keeps
client writes out of the standby (replication applies bypass the
ownership check by construction); `promote()` fences the PRIMARY,
drains every predicate to the primary's post-fence CDC head (the
write-lock barrier read move_status provides), bumps the standby's
ts/uid leases past the primary's, and flips the standby to a writable
primary — measuring RPO (commits drained after the fence; 0 lost on a
clean promote) and RTO (fence -> writable wall time).

Ref: dgraph's enterprise CDC/backup-based DR story; the in-cluster
analogue is worker/draft.go's move machinery, which this reuses
wholesale across the cluster boundary.

Port of `dgraph_tpu/cluster/replication.py`: a copy, its imports pointed at
this package.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from dgraph_tpu_torch.utils import metrics
from dgraph_tpu_torch.utils.logger import log


class PromoteError(RuntimeError):
    """Promotion could not complete safely (primary unreachable
    without force, or the drain did not converge)."""


class ReplicationDriver:
    """Leader-only standby replication loop + promotion, owned by the
    standby cluster's ZeroServer. All cross-cluster I/O goes through
    ClusterClients built per pass (leader-following on both sides)."""

    def __init__(self, zero, primary_addrs: dict[int, tuple[str, int]],
                 tick_s: float = 0.5, batch_limit: int = 512,
                 chunk_bytes: int = 1 << 20,
                 drain_timeout_s: float = 30.0):
        self.zero = zero  # the standby ZeroServer
        self.primary_addrs = dict(primary_addrs)
        self.tick_s = float(tick_s)
        self.batch_limit = int(batch_limit)
        self.chunk_bytes = int(chunk_bytes)
        self.drain_timeout_s = float(drain_timeout_s)
        # leader-local observability (recomputed after a leader
        # change, never authoritative): pred -> {"lag": entries
        # behind the primary head, "applied_ts": standby watermark,
        # "src_head": primary cdc head offset, "caught_up_at":
        # monotonic instant lag last hit 0 (None = never)}
        # guards progress/_primary_ok/_promoting: run() mutates them
        # on the driver thread while lag_payload()/promote() read and
        # flip them from ZeroServer request handlers
        self._lock = threading.Lock()
        self.progress: dict[str, dict] = {}
        self._primary_ok = False
        self._promoting = False

    # ------------------------------------------------------- clients

    def _primary_zero(self):
        from dgraph_tpu_torch.cluster.client import ClusterClient
        return ClusterClient(self.primary_addrs, timeout=30.0)

    @staticmethod
    def _group_client_from(alphas: dict, gid: int):
        from dgraph_tpu_torch.cluster.client import ClusterClient
        addrs = {rec["id"]: tuple(rec["client"])
                 for rec in alphas.values() if rec["group"] == gid}
        return ClusterClient(addrs, timeout=30.0) if addrs else None

    # --------------------------------------------------------- phase

    def phase(self) -> str:
        with self.zero.lock:
            return self.zero.state.repl_phase

    def ensure_standby(self) -> None:
        """Idempotently mark this cluster a fenced standby (replicated
        — survives zero leader changes). Never demotes a promoted
        cluster back: promotion is one-way."""
        with self.zero.lock:
            phase = self.zero.state.repl_phase
            fenced = self.zero.state.write_fence
        if phase in ("promoting", "promoted"):
            return
        if phase != "standby":
            self.zero.propose_and_wait(("repl_phase", ("standby",)))
        if not fenced:
            self.zero.propose_and_wait(("set_write_fence", (True,)))

    # ----------------------------------------------------- main loop

    def run(self) -> None:
        """The standby loop: tick until promoted or shut down."""
        while not self.zero._stop.wait(self.tick_s):
            with self._lock:
                promoting = self._promoting
            if not self.zero.is_leader() or promoting:
                continue
            try:
                if self.tick() == "promoted":
                    return
            except Exception as e:  # noqa: BLE001 — retry next tick  # dglint: disable=DG07 (standby replication daemon; no request context)
                log.warning("repl_tick_retry", error=str(e)[:200])

    def tick(self) -> str:
        """One replication pass over every primary tablet. Returns the
        phase so the loop can stop once promoted."""
        self.ensure_standby()
        phase = self.phase()
        if phase == "promoted":
            return phase
        pz = self._primary_zero()
        try:
            got = pz.request({"op": "cluster_state"})
            if not got.get("ok"):
                with self._lock:
                    self._primary_ok = False
                return phase
            cstate = got["result"]
            st = pz.request({"op": "status"})
            with self._lock:
                self._primary_ok = True
            if st.get("ok"):
                # keep the standby's ts/uid leases at or past the
                # primary's: post-promotion timestamps must never
                # collide with replicated commits
                self.zero.propose_and_wait(
                    ("bump_maxes", (int(st["result"]["max_ts"]),
                                    int(st["result"]["next_uid"]))))
            for pred, src_gid in sorted(cstate["tablets"].items()):
                try:
                    self._sync_pred(pred, int(src_gid),
                                    cstate["alphas"])
                except Exception as e:  # noqa: BLE001 — per-pred isolation  # dglint: disable=DG07 (standby replication daemon; no request context)
                    log.warning("repl_sync_retry", pred=pred,
                                error=str(e)[:200])
            # hash-range split predicates have no single source group;
            # replicating them would need per-shard tails — out of
            # scope, surfaced rather than silently skipped
            for pred in cstate.get("splits", {}):
                with self._lock:
                    self.progress.setdefault(pred, {})[
                        "unsupported"] = ("split predicate "
                                          "(replicate before "
                                          "splitting)")
        finally:
            pz.close()
        return self.phase()

    # ------------------------------------------------------ per-pred

    def _dst_group(self, pred: str) -> Optional[int]:
        """The standby group serving this predicate — claimed on
        first sight at the standby's LEAST-POPULATED group (the
        standby's zero owns its own placement; primary group ids
        need not exist over here)."""
        with self.zero.lock:
            owned = self.zero.state.tablets.get(pred)
            groups = sorted({rec["group"] for rec
                             in self.zero.state.alphas.values()})
            counts = {g: 0 for g in groups}
            for p, g in self.zero.state.tablets.items():
                if g in counts:
                    counts[g] += 1
        if owned is not None:
            return owned
        if not groups:
            return None  # no standby alphas registered yet
        gid = min(groups, key=lambda g: (counts[g], g))
        ok, got = self.zero.propose_and_wait(("tablet", (pred, gid)))
        return int(got) if ok else None

    def _sync_pred(self, pred: str, src_gid: int,
                   primary_alphas: dict) -> None:
        dst_gid = self._dst_group(pred)
        if dst_gid is None:
            return
        src_cl = self._group_client_from(primary_alphas, src_gid)
        dst_cl = self.zero._group_client(dst_gid)
        if src_cl is None or dst_cl is None:
            for cl in (src_cl, dst_cl):
                if cl is not None:
                    cl.close()
            return
        try:
            st = dst_cl._unwrap(dst_cl.request(
                {"op": "move_dst_status", "pred": pred}))
            if not st["installed"]:
                self._snapshot_pred(pred, src_cl, dst_cl, st)
                st = dst_cl._unwrap(dst_cl.request(
                    {"op": "move_dst_status", "pred": pred}))
            self._tail_pred(pred, src_cl, dst_cl,
                            int(st["max_commit_ts"]))
        finally:
            src_cl.close()
            dst_cl.close()

    def _snapshot_pred(self, pred: str, src_cl, dst_cl,
                       st: dict) -> None:
        """Stream the base copy primary -> standby through the move
        export surface (chunks are re-deliverable; an interrupted
        stream resumes from the staged sequence)."""
        begin = src_cl._unwrap(src_cl.request(
            {"op": "move_export_begin", "pred": pred,
             "prefer_snap_ts": st.get("staged_snap_ts", 0),
             "chunk_bytes": self.chunk_bytes}))
        snap_ts = int(begin["snap_ts"])
        nchunks = int(begin["chunks"])
        first = 0
        if snap_ts and snap_ts == int(st.get("staged_snap_ts", 0)):
            first = min(int(st.get("have_chunks", 0)), nchunks)
        for seq in range(first, nchunks):
            if self.zero._stop.is_set() or not self.zero.is_leader():
                return
            got = src_cl._unwrap(src_cl.request(
                {"op": "move_chunk", "pred": pred,
                 "snap_ts": snap_ts, "seq": seq}))
            dst_cl._unwrap(dst_cl.request(
                {"op": "move_stage_chunk", "pred": pred,
                 "snap_ts": snap_ts, "seq": seq, "total": nchunks,
                 "data": got["data"]}))
            metrics.inc_counter("dgraph_repl_streamed_bytes_total",
                                len(got["data"]))
        inst = dst_cl.request({"op": "repl_install", "pred": pred,
                               "snap_ts": snap_ts})
        if not inst.get("ok"):
            raise RuntimeError(f"repl install {pred!r}: "
                               f"{inst.get('error')}")
        src_cl.request({"op": "move_export_end", "pred": pred})

    def _tail_pred(self, pred: str, src_cl, dst_cl,
                   have_ts: int, rounds: int = 64) -> int:
        """Tail the primary's raw change log onto the standby until
        caught up (or `rounds` batches). Returns the remaining lag in
        change-log entries; records per-pred progress."""
        from dgraph_tpu_torch.cdc.changelog import offset_for_ts
        with self._lock:
            prog = self.progress.setdefault(
                pred, {"lag": None, "applied_ts": 0, "src_head": 0,
                       "caught_up_at": None, "commits_applied": 0})
            prog.pop("unsupported", None)
        for _ in range(rounds):
            if self.zero._stop.is_set():
                return prog["lag"] or 0
            got = src_cl.request(
                {"op": "move_deltas", "pred": pred,
                 "after": offset_for_ts(have_ts),
                 "limit": self.batch_limit})
            if not got.get("ok"):
                if got.get("truncated"):
                    # the primary's bounded ring evicted past our
                    # watermark: drop the stale standby copy and
                    # re-snapshot (truncation -> resync contract)
                    dst_cl.request({"op": "drop_tablet", "pred": pred})
                    log.info("repl_resync", pred=pred,
                             resync_ts=got["truncated"].get("resyncTs"))
                    return prog["lag"] or 0
                raise RuntimeError(f"deltas {pred!r}: "
                                   f"{got.get('error')}")
            res = got["result"]
            if res["batches"]:
                ap = dst_cl.request({"op": "move_apply", "pred": pred,
                                     "batches": res["batches"]})
                if not ap.get("ok"):
                    raise RuntimeError(f"apply {pred!r}: "
                                       f"{ap.get('error')}")
                have_ts = int(ap["result"]["max_commit_ts"])
                prog["commits_applied"] = \
                    prog.get("commits_applied", 0) + len(res["batches"])
            lag = int(res["behind"])
            prog["lag"] = lag
            prog["applied_ts"] = have_ts
            prog["src_head"] = int(res.get("head", 0))
            metrics.set_gauge("dgraph_repl_lag_entries", lag,
                              labels={"pred": pred})
            if not res["batches"] and not lag:
                prog["caught_up_at"] = time.monotonic()
                return 0
        return prog["lag"] or 0

    # ----------------------------------------------------- promotion

    def lag_payload(self) -> dict:
        """Per-predicate replication lag for /debug/stats and dgtop:
        entries behind the primary head, plus seconds since this
        predicate was last fully caught up (the freshness signal the
        runbook's RPO estimate reads)."""
        now = time.monotonic()
        preds = {}
        with self._lock:
            snapshot = sorted(self.progress.items())
            primary_ok = self._primary_ok
        for pred, prog in snapshot:
            if "unsupported" in prog:
                preds[pred] = {"unsupported": prog["unsupported"]}
                continue
            at = prog.get("caught_up_at")
            preds[pred] = {
                "lag": prog.get("lag"),
                "applied_ts": prog.get("applied_ts", 0),
                "lag_s": round(now - at, 3) if at is not None
                else None}
        return {"phase": self.phase(),
                "primary_reachable": primary_ok,
                "preds": preds}

    def promote(self, force: bool = False) -> dict:
        """Promote this standby to a writable primary. Clean path:
        fence the primary's client writes, drain every predicate to
        the primary's POST-FENCE cdc head (move_status acquires the
        primary group's write lock, so that head covers every commit
        that passed its ownership check), then flip. RPO = commits
        drained after the fence landed (0 lost); RTO = fence ->
        writable wall time. With the primary unreachable, `force`
        promotes on the standby's last applied state — RPO is then the
        unreplicated tail, surfaced as rpo_clean=False."""
        with self._lock:
            if self._promoting:
                raise PromoteError("promotion already in progress")
            self._promoting = True
        t0 = time.monotonic()
        try:
            clean = True
            heads: dict[str, int] = {}
            pz = self._primary_zero()
            try:
                fenced = pz.request({"op": "set_write_fence",
                                     "args": (True,)})
                if not fenced.get("ok"):
                    raise RuntimeError(fenced.get("error",
                                                  "fence refused"))
                cstate = pz._unwrap(pz.request({"op": "cluster_state"}))
                st = pz._unwrap(pz.request({"op": "status"}))
                self.zero.propose_and_wait(
                    ("bump_maxes", (int(st["max_ts"]),
                                    int(st["next_uid"]))))
            except Exception as e:  # noqa: BLE001 — unreachable primary is the promotion's input condition  # dglint: disable=DG07 (disaster-recovery path; error becomes the rpo_clean flag)
                if not force:
                    raise PromoteError(
                        "primary unreachable; promote with force=True "
                        "to accept losing the unreplicated tail "
                        f"({e})") from e
                clean = False
                cstate = None
            finally:
                pz.close()
            self.zero.propose_and_wait(("repl_phase", ("promoting",)))
            drained = 0
            if clean and cstate is not None:
                drained, heads = self._drain(cstate)
            self.zero.propose_and_wait(("repl_phase", ("promoted",)))
            self.zero.propose_and_wait(("set_write_fence", (False,)))
            rto_ms = round((time.monotonic() - t0) * 1000, 1)
            out = {"promoted": True, "rpo_clean": clean,
                   "rpo_commits_drained": drained,
                   "rto_ms": rto_ms,
                   "preds": {p: {"drained_to_head": h}
                             for p, h in sorted(heads.items())}}
            if not clean:
                out["rpo_note"] = ("primary unreachable: commits past "
                                   "each predicate's applied_ts are "
                                   "lost")
                with self._lock:
                    out["preds"] = {
                        p: {"applied_ts": prog.get("applied_ts", 0),
                            "last_known_lag": prog.get("lag")}
                        for p, prog in sorted(self.progress.items())}
            metrics.observe("dgraph_repl_promote_rto_ms", rto_ms)
            log.info("standby_promoted", clean=clean,
                     drained=drained, rto_ms=rto_ms)
            return out
        finally:
            with self._lock:
                self._promoting = False

    def _drain(self, cstate: dict) -> tuple[int, dict]:
        """Drain every predicate to the fenced primary's cdc head.
        Returns (commits applied during the drain, per-pred head)."""
        from dgraph_tpu_torch.cdc.changelog import offset_for_ts
        deadline = time.monotonic() + self.drain_timeout_s
        drained = 0
        heads: dict[str, int] = {}
        for pred, src_gid in sorted(cstate["tablets"].items()):
            dst_gid = self._dst_group(pred)
            if dst_gid is None:
                raise PromoteError(
                    f"no standby group for {pred!r}; cannot drain")
            src_cl = self._group_client_from(cstate["alphas"],
                                             int(src_gid))
            dst_cl = self.zero._group_client(dst_gid)
            if src_cl is None or dst_cl is None:
                raise PromoteError(f"groups unreachable for {pred!r}")
            with self._lock:
                c0 = self.progress.get(pred, {}) \
                    .get("commits_applied", 0)
            try:
                # the barrier read: after the fence, move_status's
                # write-lock acquisition proves every in-flight commit
                # has fully applied and is covered by this head
                sst = src_cl._unwrap(src_cl.request(
                    {"op": "move_status", "pred": pred}))
                head = int(sst["cdc_head"])
                heads[pred] = head
                while True:
                    st = dst_cl._unwrap(dst_cl.request(
                        {"op": "move_dst_status", "pred": pred}))
                    if not st["installed"]:
                        self._snapshot_pred(pred, src_cl, dst_cl, st)
                        continue
                    covered = offset_for_ts(int(st["max_commit_ts"]))
                    if covered >= head:
                        break
                    self._tail_pred(pred, src_cl, dst_cl,
                                    int(st["max_commit_ts"]), rounds=8)
                    if time.monotonic() > deadline:
                        raise PromoteError(
                            f"drain of {pred!r} did not converge "
                            f"within {self.drain_timeout_s}s "
                            f"(covered {covered} < head {head})")
                with self._lock:
                    drained += self.progress.get(pred, {}) \
                        .get("commits_applied", 0) - c0
            finally:
                src_cl.close()
                dst_cl.close()
        return drained, heads
