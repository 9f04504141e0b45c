"""Distributed ingest: cluster-parallel map → shuffle → reduce.

The single-core loader (ingest/bulk.py) is one process end to end; at
scale its reduce is the bottleneck (ROADMAP item 3) and its map is
GIL-bound. This module parallelizes the whole pipeline the way the
reference's bulk loader does (bulk/mapper.go fan-out → reduce shards →
out/<i>/p Badger dirs), with the Coded-TeraSort map→shuffle→reduce
shape (PAPERS.md) over the repo's own wire framing:

  driver    owns the input: streams line-aligned text chunks to map
            workers in file order, pre-assigning blank-node uids with
            the sharded, lock-striped XidMap (ingest/xidmap.py) so uid
            assignment is deterministic and IDENTICAL to the
            single-core loader's on blank-node inputs — the bench's
            byte-parity oracle depends on it.
  workers   (N processes) parse chunks through the exact python
            grammar (gql/nquad.parse_rdf), partition every statement
            by predicate → reduce group, and STREAM the per-predicate
            parts to the owning group's reducer over wire-framed
            sockets (the shuffle). Chunk delivery is transactional:
            chunk_begin → parts → chunk_commit, so a worker SIGKILLed
            mid-shuffle leaves only uncommitted staging behind and the
            reassigned chunk re-streams idempotently — the retried
            shard reduces to BYTE-IDENTICAL output.
  reducers  (one process per group) spill committed parts to
            per-predicate run files, then reduce each predicate with
            the SAME kernel the single-core loader uses
            (bulk.reduce_predicate: segmented lexsort + unique,
            in-file-order value merges) and write the group's tablets
            straight into a bootable group-varint snapshot
            (storage/snapshot.py `edges_gv`/`reverse_gv`/`index_gv` at
            rest — no second encode pass): `g<k>/p.snap` boots an
            Alpha group via `node --snapshot` exactly like the
            single-core `bulk --reduce-shards` output.

Group partition: pred → crc32(pred) % groups (deterministic, no
coordination); the manifest records the realized tablet map and the
ts/uid watermarks Zero must honor at boot (bump_maxes, the same
contract as bulk_shard_outputs).

Chaos seams: `ingest.shuffle` fires before every part send,
`ingest.reduce` before every predicate's reduce (utils/failpoint.py).

Port of `dgraph_tpu/ingest/distributed.py`. Workers and reducers run
as `python -m dgraph_tpu_torch.ingest.distributed` with
CUDA_VISIBLE_DEVICES empty, so no child process opens a CUDA context. A
reducer builds its engine on the CPU by name (`GraphDB(device="cpu")`):
it only reduces host tablets and writes their snapshot, as the
reference's reducers do on its host backend; the engine that opens the
reduced output runs on its caller's device.
"""

from __future__ import annotations

import json
import os
import queue
import re
import socket
import struct
import sys
import tempfile
import threading
import time
import zlib
from typing import Iterator, Optional

from dgraph_tpu_torch import wire
from dgraph_tpu_torch.utils import failpoint, metrics
from dgraph_tpu_torch.utils.logger import log

_DEFAULT_CHUNK_BYTES = 1 << 20


def pred_group(pred: str, groups: int) -> int:
    """Deterministic predicate → reduce-group partition (1-based)."""
    return zlib.crc32(pred.encode()) % groups + 1


def _rpc(sock: socket.socket, req: dict) -> dict:
    wire.write_frame(sock, wire.dumps(req))
    return wire.loads(wire.read_frame(sock))


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

# blank-node labels, scanned OUTSIDE quoted literals (see _chunk_xids)
_BLANK_RE = re.compile(r"_:[A-Za-z0-9_.\-]+")
# explicit numeric uid refs (<0x5> / <123>): their high-water mark must
# bump the driver's lease counter BEFORE later blank assignments, the
# same ordering contract the single-core map loop keeps
_EXPLICIT_RE = re.compile(r"<(0[xX][0-9a-fA-F]+|[0-9]+)>")
# one C-speed pass blanks out quoted literals (escape-aware) so the
# ref scans below can run over the WHOLE chunk in document order —
# a per-line python loop here was the map phase's serial bottleneck
_QUOTED_RE = re.compile(r'"(?:[^"\\]|\\.)*"')


class _ExecProc:
    """subprocess.Popen behind the multiprocessing.Process lifecycle
    surface the driver uses (is_alive/terminate/kill/join/pid)."""

    def __init__(self, popen):
        self._p = popen
        self.pid = popen.pid

    def is_alive(self) -> bool:
        return self._p.poll() is None

    def terminate(self):
        self._p.terminate()

    def kill(self):
        self._p.kill()

    def join(self, timeout=None):
        try:
            self._p.wait(timeout=timeout)
        except Exception:  # noqa: BLE001 — join() never raises
            pass


class IngestDriver:
    """Owns one distributed load end to end: chunk streaming, xid
    assignment, worker/reducer lifecycle, the manifest. `workers=N`
    spawns N map processes (in_process=True runs them as threads over
    the same sockets — the unit-test mode; thread maps are GIL-bound
    and prove protocol correctness, not speed)."""

    def __init__(self, paths, schema: str = "", *, groups: int = 2,
                 workers: int = 2, outdir: str,
                 chunk_bytes: int = _DEFAULT_CHUNK_BYTES,
                 in_process: bool = False,
                 timeout_s: float = 600.0,
                 custom_tokenizers: tuple = ()):
        self.paths = list(paths)
        self.schema = schema
        # plugin tokenizer files: reducers run db.alter + index
        # rebuilds in THEIR OWN processes, so the paths must ride the
        # reduce command and load there — registering them in the
        # driver alone would fail every @index(<plugin>) schema
        self.custom_tokenizers = tuple(custom_tokenizers)
        self.groups = groups
        self.workers = workers
        self.outdir = outdir
        self.chunk_bytes = chunk_bytes
        self.in_process = in_process
        self.timeout_s = timeout_s

        from dgraph_tpu_torch.cluster.coordinator import Coordinator
        from dgraph_tpu_torch.ingest.xidmap import XidMap
        self._coord = Coordinator()
        self._xidmap = XidMap(self._coord)
        # producer-thread-only read cache over the XidMap: one plain
        # dict hit per label OCCURRENCE, the striped-lock assign only
        # per NEW label (the resolve RPC path goes straight to the
        # XidMap, which dedupes — no coherence issue)
        self._xid_cache: dict[str, int] = {}
        self._bumped = 0

        self._lock = threading.Lock()
        # producer thread pre-scans chunks into this bounded queue so
        # the xid scan overlaps worker parses instead of serializing
        # them behind the next_chunk lock (None = exhausted sentinel)
        self._chunk_q: queue.Queue = queue.Queue(maxsize=8)
        self._requeued: list[tuple[int, str, dict]] = []
        self._pending: dict[int, tuple[str, dict]] = {}  # id -> payload
        self._assigned: dict[int, set[int]] = {}  # conn id -> chunk ids
        self._done_chunks = 0
        self._map_exhausted = False
        self._reducers: dict[int, tuple[str, int]] = {}
        self._want_inventory = False
        self._spill_sizes: dict[int, dict] = {}
        self._reduce_cmds: dict[int, dict] = {}
        self._reduce_done: dict[int, dict] = {}
        self._failed: Optional[str] = None
        self.stats = {"chunks": 0, "mapped": 0, "shuffled_bytes": 0,
                      "resolve_rpcs": 0}
        self.worker_procs: list = []  # mp.Process / threads
        self._reducer_procs: list = []
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(64)
        self.addr = self._listener.getsockname()

    # ------------------------------------------------------------ chunking

    def _chunk_iter(self) -> Iterator[str]:
        """Line-aligned text chunks across all inputs, in file order
        (gzip transparent — the same reader the single-core fast path
        uses, smaller blocks for work distribution)."""
        from dgraph_tpu_torch.ingest.bulk import _raw_text_chunks
        for p in self.paths:
            yield from _raw_text_chunks(p, chunk_bytes=self.chunk_bytes)

    def _producer(self):
        """Serial chunk producer: read → xid pre-scan → queue. ONE
        thread, so assignment order stays chunk order (deterministic)
        while workers drain the queue concurrently."""
        try:
            for chunk_id, text in enumerate(self._chunk_iter()):
                xids = self._chunk_xids(text)
                with self._lock:
                    self.stats["chunks"] += 1
                self._chunk_q.put((chunk_id, text, xids))
        except Exception as e:  # noqa: BLE001 — fail the run, visibly
            with self._lock:
                self._failed = f"chunk producer: " \
                               f"{type(e).__name__}: {e}"
        finally:
            self._chunk_q.put(None)

    def _chunk_xids(self, text: str) -> dict:
        """Pre-assign every blank-node label in `text`, in textual
        order, via the shared lock-striped XidMap — the driver is the
        ONE place assignment order is serial, which is what makes
        worker-parallel maps produce the same uids as the single-core
        loader (subject scans before object on each line, lines in
        file order — finditer is document order). Quoted literals are
        blanked by one escape-aware regex pass first, so a label-
        looking string inside a value never assigns. Explicit numeric
        uids bump the lease high-water BEFORE this chunk's blank
        assignments (chunk granularity; the single-core loader
        interleaves per statement, so a chunk mixing explicit uids
        with blanks keeps correctness but not oracle uid-parity —
        blank-node-only inputs, the bulk-loader norm, stay exact).
        External non-numeric xids resolve through the worker's
        `resolve` RPC instead."""
        if '"' in text:
            text = _QUOTED_RE.sub('""', text)
        hi = 0
        for m in _EXPLICIT_RE.finditer(text):
            v = int(m.group(1), 0)
            if v > hi:
                hi = v
        with self._lock:
            if hi > self._bumped:
                self._coord.bump_uids(hi)
                self._bumped = hi
        out: dict[str, int] = {}
        cache = self._xid_cache
        for m in _BLANK_RE.finditer(text):
            xid = m.group(0)
            if xid not in out:
                uid = cache.get(xid)
                if uid is None:
                    uid = cache[xid] = self._xidmap.assign(xid)
                out[xid] = uid
        return out

    # ------------------------------------------------------------- control

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 daemon=True)
            t.start()
            with self._lock:
                self._threads.append(t)

    def _conn_loop(self, conn: socket.socket):
        cid = id(conn)
        try:
            while not self._stop.is_set():
                req = wire.loads(wire.read_frame(conn))
                wire.write_frame(conn, wire.dumps(self._handle(cid,
                                                               req)))
        except (EOFError, OSError, wire.WireError):
            pass
        finally:
            conn.close()
            # a dead worker's in-flight chunks go back to the queue
            with self._lock:
                for chunk_id in self._assigned.pop(cid, set()):
                    payload = self._pending.get(chunk_id)
                    if payload is not None:
                        self._requeued.append(
                            (chunk_id, payload[0], payload[1]))

    def _handle(self, cid: int, req: dict) -> dict:
        op = req.get("op")
        if op == "hello":
            with self._lock:
                ready = len(self._reducers) == self.groups
                shuffle = {g: list(a)
                           for g, a in self._reducers.items()}
            return {"ok": True, "ready": ready, "groups": self.groups,
                    "shuffle": shuffle}
        if op == "register_reducer":
            with self._lock:
                self._reducers[int(req["group"])] = tuple(req["addr"])
            return {"ok": True}
        if op == "next_chunk":
            # dequeue AND book-keep under ONE lock hold: a chunk
            # popped but not yet in _pending would let a racing
            # thread's sentinel flip _map_exhausted and the driver
            # declare the map complete with that chunk unmapped —
            # silent data loss in the reduced shards (review finding)
            with self._lock:
                if self._requeued:
                    item = self._requeued.pop(0)
                elif self._map_exhausted:
                    return {"ok": True, "done": True}
                else:
                    try:
                        item = self._chunk_q.get_nowait()
                    except queue.Empty:
                        return {"ok": True, "wait": True}
                    if item is None:  # producer's exhausted sentinel
                        self._map_exhausted = True
                        return {"ok": True, "done": True}
                chunk_id, text, xids = item
                self._pending[chunk_id] = (text, xids)
                self._assigned.setdefault(cid, set()).add(chunk_id)
            return {"ok": True, "chunk": chunk_id, "text": text,
                    "xids": xids}
        if op == "resolve":
            # scanner-missed labels (escaped-quote lines, external
            # xids): first-seen order is RPC arrival here — correct,
            # just not oracle-uid-identical
            with self._lock:
                self.stats["resolve_rpcs"] += 1
                uids = {x: self._xidmap.assign(str(x))
                        for x in req["xids"]}
            return {"ok": True, "uids": uids}
        if op == "chunk_done":
            with self._lock:
                self._pending.pop(int(req["chunk"]), None)
                self._assigned.get(cid, set()).discard(
                    int(req["chunk"]))
                self._done_chunks += 1
                st = req.get("stats", {})
                self.stats["mapped"] += int(st.get("mapped", 0))
                self.stats["shuffled_bytes"] += int(
                    st.get("shuffled_bytes", 0))
                hi = int(st.get("max_uid", 0))
            with self._lock:
                if hi > self._bumped:
                    self._coord.bump_uids(hi)
                    self._bumped = max(self._bumped, hi)
            metrics.inc_counter("dgraph_ingest_mapped_total",
                                int(st.get("mapped", 0)))
            metrics.inc_counter("dgraph_ingest_shuffled_bytes_total",
                                int(st.get("shuffled_bytes", 0)))
            return {"ok": True}
        if op == "reducer_poll":
            g = int(req.get("group", 0))
            with self._lock:
                if self._failed:
                    return {"ok": True, "abort": self._failed}
                if len(self._reduce_done) == self.groups:
                    # every group reduced: reducers may tear down
                    # their shuffle listeners + spill files NOW — not
                    # before, because a slower peer may still be
                    # streaming rebalanced spill runs (fetch_spill)
                    # from this one
                    return {"ok": True, "exit": True}
                if g in self._reduce_done:
                    return {"ok": True, "wait": True}  # linger
                cmd = self._reduce_cmds.get(g)
                if cmd is not None:
                    return {"ok": True, "reduce": cmd}
                if self._want_inventory and g not in self._spill_sizes:
                    return {"ok": True, "inventory": True}
            return {"ok": True, "wait": True}
        if op == "spill_sizes":
            with self._lock:
                self._spill_sizes[int(req["group"])] = {
                    str(p): int(b)
                    for p, b in req.get("sizes", {}).items()}
            return {"ok": True}
        if op == "reduce_done":
            g = int(req["group"])
            with self._lock:
                self._reduce_done[g] = req.get("stats", {})
            metrics.inc_counter(
                "dgraph_ingest_reduced_total",
                int(req.get("stats", {}).get("reduced", 0)))
            return {"ok": True}
        if op == "failed":
            with self._lock:
                self._failed = str(req.get("error", "worker failed"))
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    # ------------------------------------------------------------- spawn

    def _spawn_procs(self):
        """Start map/reduce processes.

        REDUCERS always exec-spawn: they import the full engine (torch
        included), and a forked child inheriting a warm parent's
        native runtime state (BLAS and OpenMP pools, a CUDA context)
        can deadlock — CPython warns exactly this. Their cold start
        overlaps the map phase completely.

        WORKERS fork when safe (driver torch-free AND single-threaded —
        run() forks BEFORE the accept/producer threads start, so no
        driver lock can be held mid-fork; children connect immediately
        because the listener's backlog queues them until the accept
        loop runs): their code path is the narrow numpy parse plane,
        and the warm interpreter shaves seconds off time-to-first-chunk.
        A torch-warm or threaded driver exec-spawns workers too.

        Every exec-spawned child sees no card (CUDA_VISIBLE_DEVICES
        empty)."""
        import subprocess
        addr = f"{self.addr[0]}:{self.addr[1]}"
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        env.setdefault("PYTHONPATH", os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        # DGRAPH_TPU_INGEST_DEBUG=1 lets child stderr through — the
        # operator's "why did my reducer die" switch
        sink = None if os.environ.get("DGRAPH_TPU_INGEST_DEBUG") \
            else subprocess.DEVNULL
        for g in range(1, self.groups + 1):
            self._reducer_procs.append(_ExecProc(subprocess.Popen(
                [sys.executable, "-m",
                 "dgraph_tpu_torch.ingest.distributed",
                 "reducer", addr, str(g)],
                env=env, stdout=sink, stderr=sink)))
        if "torch" not in sys.modules and threading.active_count() == 1:
            import multiprocessing
            ctx = multiprocessing.get_context("fork")
            for _ in range(self.workers):
                p = ctx.Process(target=run_worker, args=(addr,),
                                daemon=True)
                p.start()
                self.worker_procs.append(p)
            return
        for _ in range(self.workers):
            self.worker_procs.append(_ExecProc(subprocess.Popen(
                [sys.executable, "-m",
                 "dgraph_tpu_torch.ingest.distributed",
                 "worker", addr],
                env=env, stdout=sink, stderr=sink)))

    def _spawn_threads(self):
        addr = f"{self.addr[0]}:{self.addr[1]}"
        for g in range(1, self.groups + 1):
            t = threading.Thread(target=run_reducer, args=(addr, g),
                                 daemon=True)
            t.start()
            with self._lock:
                self._threads.append(t)
        for _ in range(self.workers):
            t = threading.Thread(target=run_worker, args=(addr,),
                                 daemon=True)
            t.start()
            with self._lock:
                self._threads.append(t)

    # --------------------------------------------------------------- run

    def run(self) -> dict:
        t0 = time.monotonic()
        # fork-safety contract: children fork BEFORE any driver
        # thread starts (see _spawn_procs); their first RPCs queue in
        # the listener backlog until the accept loop is up
        if not self.in_process:
            self._spawn_procs()
        accept = threading.Thread(target=self._serve, daemon=True)
        accept.start()
        with self._lock:
            self._threads.append(accept)
        producer = threading.Thread(target=self._producer, daemon=True)
        producer.start()
        with self._lock:
            self._threads.append(producer)
        if self.in_process:
            self._spawn_threads()
        try:
            return self._drive(t0)
        finally:
            self.close()

    def _drive(self, t0: float) -> dict:
        deadline = time.monotonic() + self.timeout_s
        # map phase: wait until the chunk stream is drained AND every
        # handed-out chunk has been committed (a dead worker's chunks
        # requeue and re-run through a healthy one)
        while True:
            with self._lock:
                if self._failed:
                    raise RuntimeError(
                        f"distributed ingest failed: {self._failed}")
                done = (self._map_exhausted and not self._pending
                        and not self._requeued)
            if done:
                break
            if time.monotonic() > deadline:
                raise TimeoutError("map phase timed out")
            if not self.in_process and self.worker_procs and \
                    not any(p.is_alive() for p in self.worker_procs):
                with self._lock:
                    stuck = (self._pending or self._requeued
                             or not self._map_exhausted)
                if stuck:
                    raise RuntimeError(
                        "every map worker exited with chunks "
                        "outstanding")
            time.sleep(0.02)
        t_map = time.monotonic()

        # ---- balance: collect per-predicate spilled bytes from every
        # group's sink, then assign predicates size-balanced (greedy,
        # the bulk_shard_outputs policy) — a hash partition alone
        # leaves few-predicate workloads wildly skewed, and the slow
        # group IS the reduce wall-clock. Predicates land where their
        # spill already lives when the balance allows; otherwise the
        # owning reducer streams the spill run to the assignee.
        with self._lock:
            self._want_inventory = True
        while True:
            with self._lock:
                if self._failed:
                    raise RuntimeError(
                        f"distributed ingest failed: {self._failed}")
                if len(self._spill_sizes) == self.groups:
                    break
            if time.monotonic() > deadline:
                raise TimeoutError("spill inventory timed out")
            time.sleep(0.02)
        sizes: dict[str, int] = {}
        home: dict[str, int] = {}
        with self._lock:
            spill_sizes = {g: dict(ss)
                           for g, ss in self._spill_sizes.items()}
        for g, ss in sorted(spill_sizes.items()):
            for p, b in ss.items():
                sizes[p] = sizes.get(p, 0) + b
                home[p] = g
        assign: dict[int, list[str]] = {g: [] for g in
                                        range(1, self.groups + 1)}
        load: dict[int, int] = {g: 0 for g in assign}
        for p in sorted(sizes, key=lambda p: (-sizes[p], p)):
            g = min(sorted(load), key=lambda k: (load[k], k != home[p]))
            assign[g].append(p)
            load[g] += sizes[p]

        # one fixed write_ts for the whole load, allocated AFTER the
        # map so the xid lease high-water is final (ref
        # bulk/loader.go getWriteTimestamp)
        write_ts = self._coord.next_ts()
        with self._lock:
            peers = {str(g): list(a)
                     for g, a in self._reducers.items()}
            for g in assign:
                self._reduce_cmds[g] = {
                    "write_ts": write_ts,
                    "max_ts": self._coord.max_assigned(),
                    "next_uid": self._coord._next_uid,
                    "schema": self.schema,
                    "custom_tokenizers": list(self.custom_tokenizers),
                    "out": os.path.abspath(self.outdir),
                    "assign": sorted(assign[g]),
                    "fetch": {p: home[p] for p in assign[g]
                              if home[p] != g},
                    "peers": peers,
                }
        while True:
            with self._lock:
                if self._failed:
                    raise RuntimeError(
                        f"distributed ingest failed: {self._failed}")
                if len(self._reduce_done) == self.groups:
                    break
                done = set(self._reduce_done)
            # a group is pinned to ONE reducer — no peer can take
            # over its reduce, so a single dead process with its
            # group unreduced must fail the load NOW, not at the
            # phase timeout (_reducer_procs[i] serves group i+1)
            dead = [g for g in range(1, self.groups + 1)
                    if g not in done and self._reducer_procs
                    and not self._reducer_procs[g - 1].is_alive()]
            if dead:
                raise RuntimeError(
                    f"reducer process(es) died with groups "
                    f"{dead} unreduced")
            if time.monotonic() > deadline:
                raise TimeoutError("reduce phase timed out")
            time.sleep(0.02)
        t_reduce = time.monotonic()

        tmap: dict[str, int] = {}
        groups: dict[str, list] = {}
        reduced = 0
        with self._lock:
            reduce_done = {g: dict(st)
                           for g, st in self._reduce_done.items()}
        for g, st in sorted(reduce_done.items()):
            preds = sorted(st.get("preds", ()))
            groups[str(g)] = preds
            reduced += int(st.get("reduced", 0))
            for p in preds:
                tmap[p] = g
        manifest = {
            "groups": groups,
            "tablets": tmap,
            "max_ts": self._coord.max_assigned(),
            "next_uid": self._coord._next_uid,
        }
        os.makedirs(self.outdir, exist_ok=True)
        with open(os.path.join(self.outdir, "manifest.json"),
                  "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.write("\n")
        with self._lock:
            self.stats.update({
                "group_stats": {str(g): {k: v for k, v in st.items()
                                         if k != "preds"}
                                for g, st in
                                sorted(reduce_done.items())},
                "reduced": reduced,
                "map_s": round(t_map - t0, 3),
                "reduce_s": round(t_reduce - t_map, 3),
                "total_s": round(t_reduce - t0, 3),
                "write_ts": write_ts,
            })
            manifest["stats"] = dict(self.stats)
        return manifest

    def close(self):
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        for p in self.worker_procs + self._reducer_procs:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + 5.0
        for p in self.worker_procs + self._reducer_procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()


def distributed_load(paths, schema: str = "", *, groups: int = 2,
                     workers: int = 2, outdir: str,
                     chunk_bytes: int = _DEFAULT_CHUNK_BYTES,
                     in_process: bool = False,
                     timeout_s: float = 600.0,
                     custom_tokenizers: tuple = ()) -> dict:
    """One-call driver: returns the manifest (with a `stats` section).
    The output directory holds `g<k>/p.snap` bootable group snapshots
    + `manifest.json`, the same contract as `bulk --reduce-shards`."""
    return IngestDriver(paths, schema, groups=groups, workers=workers,
                        outdir=outdir, chunk_bytes=chunk_bytes,
                        in_process=in_process, timeout_s=timeout_s,
                        custom_tokenizers=custom_tokenizers).run()


# --------------------------------------------------------------------------
# map worker
# --------------------------------------------------------------------------


def _dial(addr: tuple[str, int], timeout: float = 30.0
          ) -> socket.socket:
    s = socket.create_connection(addr, timeout=timeout)
    s.settimeout(timeout)
    return s


def _parse_addr(spec: str) -> tuple[str, int]:
    host, port = spec.rsplit(":", 1)
    return host, int(port)


def run_worker(driver_addr: str):
    """Map-worker loop: pull chunks, parse, partition, shuffle. Runs
    as its own process (`python -m dgraph_tpu_torch.ingest.distributed
    worker host:port`) importing only the parse path."""
    from dgraph_tpu_torch.gql.nquad import parse_rdf

    import numpy as np

    driver = _dial(_parse_addr(driver_addr))
    # wait for every reducer to register before mapping
    while True:
        cfg = _rpc(driver, {"op": "hello"})
        if cfg.get("ready"):
            break
        time.sleep(0.05)
    groups = int(cfg["groups"])
    shuffles = {int(g): _dial(tuple(a))
                for g, a in cfg["shuffle"].items()}
    xid_cache: dict[str, int] = {}

    def resolve(chunk_xids: dict, ref: str) -> int:
        uid = chunk_xids.get(ref)
        if uid is not None:
            return uid
        if not ref.startswith("_:"):
            try:
                return int(ref, 0)
            except ValueError:
                pass
        uid = xid_cache.get(ref)
        if uid is None:
            got = _rpc(driver, {"op": "resolve", "xids": [ref]})
            uid = int(got["uids"][ref])
            xid_cache[ref] = uid
        return uid

    try:
        while True:
            task = _rpc(driver, {"op": "next_chunk"})
            if task.get("done"):
                break
            if task.get("wait"):
                time.sleep(0.01)  # producer hasn't scanned one yet
                continue
            chunk = int(task["chunk"])
            chunk_xids = {k: int(v) for k, v in task["xids"].items()}
            # ---- map: parse + partition by predicate. Values ship
            # COLUMNAR (uid/Val/sparse-lang/sparse-facet columns, file
            # positions implicit in column order): a (src, Posting,
            # idx) tuple per value cost ~20 µs of generic TLV decode
            # on the reduce side — at LDBC shape (value-dominated)
            # that was the reducer's largest line item ----
            parts: dict[str, dict] = {}
            max_uid = 0
            n = 0
            for nq in parse_rdf(task["text"]):
                src = resolve(chunk_xids, nq.subject)
                max_uid = max(max_uid, src)
                part = parts.get(nq.predicate)
                if part is None:
                    part = parts[nq.predicate] = {
                        "src": [], "dst": [], "facets": [],
                        "vsrc": [], "vval": [], "vlang": [],
                        "vfacets": []}
                if nq.object_id:
                    dst = resolve(chunk_xids, nq.object_id)
                    max_uid = max(max_uid, dst)
                    part["src"].append(src)
                    part["dst"].append(dst)
                    if nq.facets:
                        part["facets"].append((src, dst, nq.facets))
                elif nq.object_value is not None:
                    if nq.lang:
                        part["vlang"].append(
                            (len(part["vsrc"]), nq.lang))
                    if nq.facets:
                        part["vfacets"].append(
                            (len(part["vsrc"]), nq.facets))
                    part["vsrc"].append(src)
                    part["vval"].append(nq.object_value)
                n += 1
            # ---- shuffle: transactional per-chunk delivery ----
            touched = sorted({pred_group(p, groups) for p in parts})
            for g in touched:
                _rpc(shuffles[g], {"op": "chunk_begin", "chunk": chunk})
            shuffled = 0
            for pred in sorted(parts):
                part = parts[pred]
                g = pred_group(pred, groups)
                # chaos seam: an armed error here kills this worker
                # mid-shuffle; the chunk requeues and re-streams
                failpoint.fire("ingest.shuffle")
                blob = wire.dumps({
                    "op": "part", "chunk": chunk, "pred": pred,
                    "srcs": np.asarray(part["src"], np.uint64),
                    "dsts": np.asarray(part["dst"], np.uint64),
                    "facets": part["facets"],
                    "vsrc": np.asarray(part["vsrc"], np.uint64),
                    "vval": part["vval"],
                    "vlang": part["vlang"],
                    "vfacets": part["vfacets"]})
                wire.write_frame(shuffles[g], blob)
                wire.loads(wire.read_frame(shuffles[g]))  # ack
                shuffled += len(blob)
            for g in touched:
                _rpc(shuffles[g], {"op": "chunk_commit",
                                   "chunk": chunk})
            _rpc(driver, {"op": "chunk_done", "chunk": chunk,
                          "stats": {"mapped": n,
                                    "shuffled_bytes": shuffled,
                                    "max_uid": max_uid}})
    except failpoint.FailpointError:
        raise  # chaos: die like a SIGKILL would, mid-protocol
    except (EOFError, OSError, wire.WireError):
        pass  # driver gone: load finished or failed without us
    finally:
        for s in shuffles.values():
            s.close()
        driver.close()


# --------------------------------------------------------------------------
# reduce group
# --------------------------------------------------------------------------


class _ShuffleSink:
    """One reduce group's shuffle receiver: stages parts per chunk,
    promotes them to per-predicate spill run files at chunk_commit.
    Re-delivery of a committed chunk is dropped whole — the
    idempotence that makes worker crash-retry byte-exact."""

    def __init__(self, tmpdir: str):
        self.tmpdir = tmpdir
        self.lock = threading.Lock()
        self.staged: dict[int, list[tuple[str, bytes]]] = {}
        self.committed: set[int] = set()
        self.files: dict[str, object] = {}

    def handle(self, req_blob: bytes) -> dict:
        req = wire.loads(req_blob)
        op = req.get("op")
        if op == "chunk_begin":
            with self.lock:
                if int(req["chunk"]) not in self.committed:
                    self.staged[int(req["chunk"])] = []
            return {"ok": True}
        if op == "part":
            with self.lock:
                chunk = int(req["chunk"])
                if chunk not in self.committed:
                    # keep the original frame: the spill file IS the
                    # wire stream, decoded once at reduce time
                    self.staged.setdefault(chunk, []).append(
                        (req["pred"], req_blob))
            return {"ok": True}
        if op == "chunk_commit":
            with self.lock:
                chunk = int(req["chunk"])
                if chunk in self.committed:
                    self.staged.pop(chunk, None)
                    return {"ok": True, "dup": True}
                for pred, blob in self.staged.pop(chunk, []):
                    f = self.files.get(pred)
                    if f is None:
                        path = os.path.join(
                            self.tmpdir,
                            f"spill-{zlib.crc32(pred.encode()):08x}"
                            f"-{len(self.files)}.run")
                        f = self.files[pred] = open(path, "wb")
                    f.write(struct.pack("<I", len(blob)))
                    f.write(blob)
                self.committed.add(chunk)
            return {"ok": True}
        if op == "fetch_spill":
            # reduce-side rebalance: a PEER group assigned one of our
            # staged predicates streams its whole spill run over
            with self.lock:
                f = self.files.get(req["pred"])
                if f is None:
                    return {"ok": True, "data": b""}
                f.flush()
                path = f.name
            with open(path, "rb") as fh:
                return {"ok": True, "data": fh.read()}
        return {"ok": False, "error": f"unknown shuffle op {op!r}"}

    def sizes(self) -> dict[str, int]:
        with self.lock:
            for f in self.files.values():
                f.flush()
            return {p: os.path.getsize(f.name)
                    for p, f in self.files.items()}

    def runs(self) -> dict[str, str]:
        with self.lock:
            for f in self.files.values():
                f.flush()
            return {p: f.name for p, f in self.files.items()}

    def close(self):
        with self.lock:
            for f in self.files.values():
                try:
                    f.close()
                except OSError:
                    pass


def _parse_runs(data: bytes) -> list[dict]:
    out = []
    pos = 0
    while pos + 4 <= len(data):
        (n,) = struct.unpack_from("<I", data, pos)
        pos += 4
        out.append(wire.loads(data[pos:pos + n]))
        pos += n
    return out


def _read_runs(path: str) -> list[dict]:
    with open(path, "rb") as f:
        return _parse_runs(f.read())


def run_reducer(driver_addr: str, group: int):
    """Reduce-group process: receive the shuffle, reduce every owned
    predicate with the shared single-core kernel, write the group's
    bootable snapshot. (`python -m dgraph_tpu_torch.ingest.distributed
    reducer host:port G`)"""
    import numpy as np

    tmpdir = tempfile.mkdtemp(prefix=f"dg-shuffle-g{group}-")
    sink = _ShuffleSink(tmpdir)
    stop = threading.Event()

    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lst.bind(("127.0.0.1", 0))
    lst.listen(64)

    def serve_conn(conn):
        try:
            while not stop.is_set():
                blob = wire.read_frame(conn)
                wire.write_frame(conn, wire.dumps(sink.handle(blob)))
        except (EOFError, OSError, wire.WireError):
            pass
        finally:
            conn.close()

    def accept_loop():
        while not stop.is_set():
            try:
                conn, _ = lst.accept()
            except OSError:
                return
            threading.Thread(target=serve_conn, args=(conn,),
                             daemon=True).start()

    threading.Thread(target=accept_loop, daemon=True).start()

    driver = _dial(_parse_addr(driver_addr))
    try:
        # register FIRST (workers gate their map on every reducer
        # being reachable), THEN pay the heavy engine imports — they
        # overlap the map phase instead of landing on either critical
        # path
        _rpc(driver, {"op": "register_reducer", "group": group,
                      "addr": list(lst.getsockname())})
        from dgraph_tpu_torch.engine.db import GraphDB
        from dgraph_tpu_torch.ingest.bulk import reduce_predicate
        from dgraph_tpu_torch.storage.snapshot import save_snapshot
        from dgraph_tpu_torch.storage.tablet import Posting
        while True:
            got = _rpc(driver, {"op": "reducer_poll", "group": group})
            if got.get("abort"):
                return
            if got.get("inventory"):
                _rpc(driver, {"op": "spill_sizes", "group": group,
                              "sizes": sink.sizes()})
                continue
            if got.get("reduce"):
                cmd = got["reduce"]
                break
            time.sleep(0.05)
        # NOTE: the shuffle listener stays up through the reduce —
        # peer groups fetch_spill rebalanced predicates from it

        t0 = time.monotonic()
        if cmd.get("custom_tokenizers"):
            from dgraph_tpu_torch.models.tokenizer import \
                load_custom_tokenizers
            load_custom_tokenizers(list(cmd["custom_tokenizers"]))
        # the CPU by name: a reducer only builds host tablets and writes
        # their snapshot (see the module docstring)
        db = GraphDB(prefer_device=False, device="cpu")
        if cmd["schema"]:
            db.alter(cmd["schema"])
        write_ts = int(cmd["write_ts"])
        reduced = 0
        t_decode = t_reduce = 0.0
        runs = sink.runs()
        fetch = {str(p): int(g)
                 for p, g in cmd.get("fetch", {}).items()}
        peers = {int(g): tuple(a)
                 for g, a in cmd.get("peers", {}).items()}
        assigned = cmd.get("assign")
        if assigned is None:
            assigned = sorted(runs)
        for pred in assigned:
            # chaos seam: delay/fail one predicate's reduce
            failpoint.fire("ingest.reduce")
            td = time.monotonic()
            if pred in runs:
                parts = _read_runs(runs[pred])
            else:
                # rebalanced here: stream the spill from its hash
                # home. Socket faults surface as RuntimeError — the
                # broad except below reports them to the driver; they
                # must never fold into the silent "driver gone" exit
                try:
                    peer = _dial(peers[fetch[pred]])
                    try:
                        got = _rpc(peer, {"op": "fetch_spill",
                                          "pred": pred})
                    finally:
                        peer.close()
                except (EOFError, OSError, wire.WireError) as e:
                    raise RuntimeError(
                        f"fetch_spill {pred!r} from g{fetch[pred]} "
                        f"failed: {type(e).__name__}: {e}") from e
                parts = _parse_runs(got.get("data", b""))
            # canonical order = (chunk, in-part position): reproduces
            # FILE ORDER regardless of worker/commit interleaving,
            # which is what makes a retried shard byte-identical and
            # the value merges match the single-core loader exactly
            parts.sort(key=lambda p: int(p["chunk"]))
            srcs = np.concatenate(
                [p["srcs"] for p in parts]) if parts \
                else np.empty(0, np.uint64)
            dsts = np.concatenate(
                [p["dsts"] for p in parts]) if parts \
                else np.empty(0, np.uint64)
            vals = []
            for p in parts:
                langs = dict(p["vlang"])
                fcs = dict(p["vfacets"])
                for j, (s, v) in enumerate(zip(p["vsrc"].tolist(),
                                               p["vval"])):
                    vals.append((s, Posting(v, langs.get(j, ""),
                                            fcs.get(j, {}))))
            facets = [(fs, fd, fc) for p in parts
                      for fs, fd, fc in p["facets"]]
            tr = time.monotonic()
            t_decode += tr - td
            reduce_predicate(db, pred, srcs, dsts, vals, facets,
                             write_ts)
            t_reduce += time.monotonic() - tr
            reduced += int(len(srcs)) + len(vals)
        db.coordinator.observe_ts(int(cmd["max_ts"]))
        db.coordinator.bump_uids(int(cmd["next_uid"]) - 1)
        gdir = os.path.join(cmd["out"], f"g{group}")
        os.makedirs(gdir, exist_ok=True)
        ts = time.monotonic()
        save_snapshot(db, os.path.join(gdir, "p.snap"))
        _rpc(driver, {"op": "reduce_done", "group": group,
                      "stats": {"preds": list(assigned),
                                "reduced": reduced,
                                "decode_s": round(t_decode, 3),
                                "reduce_s": round(t_reduce, 3),
                                "snap_s": round(
                                    time.monotonic() - ts, 3),
                                "total_s": round(
                                    time.monotonic() - t0, 3)}})
        # LINGER until every group is done: a slower peer may still
        # be fetch_spill-streaming rebalanced predicates from our
        # sink — tearing it down early strands that group
        while True:
            got = _rpc(driver, {"op": "reducer_poll",
                                "group": group})
            if got.get("exit") or got.get("abort"):
                break
            time.sleep(0.05)
    except (EOFError, OSError, wire.WireError):
        pass  # driver gone
    except Exception as e:  # noqa: BLE001 — surface to the driver
        try:
            _rpc(driver, {"op": "failed",
                          "error": f"reducer g{group}: "
                                   f"{type(e).__name__}: {e}"})
        except Exception:  # noqa: BLE001
            pass
        raise
    finally:
        stop.set()
        try:
            lst.close()
        except OSError:
            pass
        sink.close()
        driver.close()
        import shutil
        shutil.rmtree(tmpdir, ignore_errors=True)


def _main(argv: list[str]) -> int:
    role = argv[0]
    if role == "worker":
        run_worker(argv[1])
        return 0
    if role == "reducer":
        run_reducer(argv[1], int(argv[2]))
        return 0
    log.error("ingest_bad_role", role=role)
    return 2


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
