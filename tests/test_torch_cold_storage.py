"""The port's cold storage (dgraph_tpu_torch: storage/kvfallback,
storage/uri, storage/bulkseed, engine/lazy_tablets, engine/prefetch,
engine/result_cache and GraphDB's store_dir, prefetch_workers,
result_cache_entries and checkpoint) against the reference's, on the
CPU.

The reference's own tests run through both packages
(`run_in_both`): once as they are, and once with every name they take
from `dgraph_tpu` rebound to the port's counterpart (engines and entry
points on `device="cpu"`), each case with the host runtime switched off
in both packages (`native.available` patched to False, so the store is
PyKV) and, in the `_native_on` tests, on in both (the store is
NativeKV, the default of either package). Each pass works in its
own directory; afterwards the two directories must hold the same
files with the same bytes (gzip members compared by their contents,
manifests apart from their wall-clock stamps, encrypted blobs by
length), and the tablet store's loads and evictions and the result
cache's hits, misses and invalidations must have moved alike. A test
the reference marks `racecheck` (test_prefetch) runs with each pass's
own runtime witness armed, and a witnessed race fails it
(`torch_twins.witnessed`).

The reference's two NativeKV tests (`test_checkpoint_compacts_store`,
`test_lsm_compaction_crash_window_no_resurrection`) run with the
runtime on only; their PyKV counterparts run here on both packages.

In the `_native_on` prefetch twins the reference's pass runs with its
`PrefetchPool.close` waiting for running decodes, as the port's does
(`drain_reference_prefetch`): as it stands, the reference closes its
store under a running decode, which kills the process.
"""

from __future__ import annotations

import gzip
import http.server
import importlib
import inspect
import json
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import dgraph_tpu.native
import dgraph_tpu_torch.native
from dgraph_tpu import wire as jwire
from dgraph_tpu.engine import lazy_tablets as jlazy
from dgraph_tpu.engine import prefetch as jprefetch
from dgraph_tpu.engine.db import GraphDB as JDB
from dgraph_tpu.storage import bulkseed as jseed
from dgraph_tpu.storage import kvfallback as jkv
from dgraph_tpu.storage import snapshot as jsnap
from dgraph_tpu.storage import uri as juri
from dgraph_tpu.utils import metrics as jmetrics
from dgraph_tpu_torch import wire as twire
from dgraph_tpu_torch.engine import lazy_tablets as tlazy
from dgraph_tpu_torch.engine.db import GraphDB as TDB
from dgraph_tpu_torch.storage import bulkseed as tseed
from dgraph_tpu_torch.storage import kvfallback as tkv
from dgraph_tpu_torch.storage import snapshot as tsnap
from dgraph_tpu_torch.storage import uri as turi
from dgraph_tpu_torch.storage.wal import _PyWal
from dgraph_tpu_torch.utils import metrics as tmetrics
from tests.torch_twins import (
    CpuGraphDB, PortModule, bind_port, witness_marks, witnessed,
)

# counters both passes of a reference test must move alike
COUNTERS = ("tablet_store_loads", "tablet_store_evictions",
            "dgraph_result_cache_hits_total",
            "dgraph_result_cache_misses_total",
            "dgraph_result_cache_invalidations_total")


# -- running a reference test through both packages --------------------------


def _fixture(ref_mod, name, where, monkeypatch, cleanups, fixtures):
    if name == "monkeypatch":
        return monkeypatch
    if name == "tmp_path":
        return where
    if name in fixtures:
        fn = fixtures[name]
    else:
        fn = getattr(ref_mod, name)._get_wrapped_function()
    args = {p: _fixture(ref_mod, p, where, monkeypatch, cleanups, fixtures)
            for p in inspect.signature(fn).parameters}
    got = fn(**args)
    if inspect.isgenerator(got):
        gen = got
        got = next(gen)
        cleanups.append(lambda: next(gen, None))
    return got


def _run_pass(ref_mod, test_name, where, params, monkeypatch, fixtures,
              collect, pkg):
    """One pass of a reference test, with `pkg`'s own runtime witnesses
    armed where the test is marked `lockcheck` or `racecheck`."""
    fn = getattr(ref_mod, test_name)
    cleanups: list = []
    with witnessed(pkg, witness_marks(fn, ref_mod)):
        try:
            args = {p: params[p] if p in params else
                    _fixture(ref_mod, p, where, monkeypatch, cleanups,
                             fixtures)
                    for p in inspect.signature(fn).parameters}
            fn(**args)
            return collect(args) if collect is not None else None
        finally:
            for c in reversed(cleanups):
                c()


def _counters(metrics, before):
    delta = metrics.counters_delta(before)
    return {c: delta.get(c, 0) for c in COUNTERS}


def _tree(root: Path) -> dict:
    """{relative path -> comparable content} of every file under root."""
    out = {}
    for p in sorted(root.rglob("*")):
        if not p.is_file():
            continue
        rel = str(p.relative_to(root))
        data = p.read_bytes()
        if p.name == "coststore.json":
            out[rel] = "observed stage costs (wall times)"
        elif p.name == "manifest.json" and data[:1] == b"[":
            out[rel] = [{k: v for k, v in e.items() if k != "unix_ts"}
                        for e in json.loads(data)]
        elif data[:2] == b"\x1f\x8b" and p.suffix == ".gz":
            out[rel] = gzip.decompress(data)
        else:
            out[rel] = data
    return out


def _engine_dumps(engines, snapshot, wire) -> list:
    """{predicate -> dump_tablet bytes} of every engine a pass built,
    in the order it built them (a closed store's: its resident
    tablets)."""
    return [{p: wire.dumps(snapshot.dump_tablet(tab))
             for p, tab in sorted(db.tablets.items())} for db in engines]


def _order(dumps) -> list:
    return sorted(dumps.items()) if dumps else []


def switch_native(mp, on: bool) -> None:
    """The host runtime on (the default) or off in both packages."""
    if not on:
        mp.setattr(dgraph_tpu.native, "available", lambda: False)
        mp.setattr(dgraph_tpu_torch.native, "available", lambda: False)


def drain_reference_prefetch(mp) -> None:
    """The reference's `PrefetchPool.close` made to wait for its running
    decodes, as the port's does. As it stands it cancels only the queued
    ones (`dgraph_tpu/engine/prefetch.py:157-162`), and `GraphDB.close`
    then closes the store under a decode still reading it: with the
    host runtime on, that decode's `NativeKV.get`
    (`dgraph_tpu/native/__init__.py:216`) reads a freed handle and the
    process dies. The reference is frozen, so its pass of the
    `_native_on` prefetch twins runs with this shim; the port's pass
    runs as it is."""
    close = jprefetch.PrefetchPool.close

    def draining(self):
        close(self)
        self._pool.shutdown(wait=True)
    mp.setattr(jprefetch.PrefetchPool, "close", draining)


def run_in_both(ref_name, test_name, tmp_path, params=None,
                compare_files=True, opaque=(), fixtures=None, collect=None,
                dumps=True, native=False, ref_setup=None):
    """Run `tests.<ref_name>.<test_name>` on the reference and on the
    port, each in its own directory, with the host runtime on or off in
    both (`native`); then hold their files and counters equal. `opaque` names files compared by length only
    (encrypted with a random nonce). `fixtures` replaces the reference
    module's fixtures by name; `collect(args)`, given the test's
    resolved arguments after each pass, returns what must be equal
    between the passes. With `dumps`, every engine either pass built
    must end with the same dump_tablet bytes as its counterpart.
    `ref_setup(monkeypatch)` runs before the reference's pass only."""
    ref_mod = importlib.import_module(f"tests.{ref_name}")
    params = dict(params or {})
    got, seen, built = {}, {}, {}
    for side in ("ref", "port"):
        where = tmp_path / side
        where.mkdir()
        mp = pytest.MonkeyPatch()
        try:
            switch_native(mp, native)
            metrics = jmetrics if side == "ref" else tmetrics
            cls, snap, wire = (JDB, jsnap, jwire) if side == "ref" \
                else (TDB, tsnap, twire)
            engines: list = []
            init = cls.__init__

            def tracked(self, *a, _init=init, _engines=engines, **kw):
                _init(self, *a, **kw)
                _engines.append(self)
            mp.setattr(cls, "__init__", tracked)
            if side == "ref" and ref_setup is not None:
                ref_setup(mp)
            if side == "port":
                bind_port(ref_mod, mp)
                # `from dgraph_tpu import native` in a test body reads
                # the package's attribute, which the sys.modules
                # aliases of bind_port do not reach
                mp.setattr(dgraph_tpu, "native",
                           PortModule(dgraph_tpu_torch.native))
            before = metrics.counters_snapshot()
            seen[side] = _run_pass(
                ref_mod, test_name, where, params, mp, fixtures or {},
                collect, "dgraph_tpu" if side == "ref" else "dgraph_tpu_torch")
            got[side] = _counters(metrics, before)
            built[side] = _engine_dumps(engines, snap, wire) if dumps \
                else [None] * len(engines)
        finally:
            mp.undo()
    assert got["port"] == got["ref"], got
    assert seen["port"] == seen["ref"]
    assert len(built["port"]) == len(built["ref"])
    # as multisets: reducer threads build their engines in any order
    assert sorted(built["port"], key=_order) == \
        sorted(built["ref"], key=_order)
    if compare_files:
        ref, port = _tree(tmp_path / "ref"), _tree(tmp_path / "port")
        assert sorted(port) == sorted(ref)
        for rel in ref:
            if Path(rel).name in opaque:
                assert len(port[rel]) == len(ref[rel]), rel
            else:
                assert port[rel] == ref[rel], f"{rel} differs"


def reference_cases(ref_name, skip=()):
    mod = importlib.import_module(f"tests.{ref_name}")
    return [name for name, obj in vars(mod).items()
            if name.startswith("test_") and inspect.isfunction(obj)
            and name not in skip]


# -- the reference's tests of lazy tablets, prefetch and the result cache ----

NATIVE_KV_ONLY = ("test_checkpoint_compacts_store",
                  "test_lsm_compaction_crash_window_no_resurrection")
LAZY = reference_cases("test_lazy_tablets", NATIVE_KV_ONLY)
PREFETCH = reference_cases("test_prefetch")
SCALEOUT_CACHE = [n for n in reference_cases("test_scaleout")
                  if "result_cache" in n or "cdc" in n or "cache_hit" in n]


def test_the_reference_files_hold_their_cases():
    assert len(LAZY) + len(NATIVE_KV_ONLY) == 6
    assert len(PREFETCH) == 8
    assert SCALEOUT_CACHE == [
        "test_result_cache_lru_bound_and_reverse_index",
        "test_result_cache_footprint_invalidation",
        "test_result_cache_truncation_drops_wholesale",
        "test_result_cache_generation_guards_fill_races",
        "test_cdc_commit_invalidates_only_the_footprint",
        "test_cache_hit_is_still_a_served_query",
        "test_cdc_truncation_vs_invalidation"]


@pytest.mark.parametrize("name", LAZY)
def test_lazy_tablets_through_both(name, tmp_path):
    run_in_both("test_lazy_tablets", name, tmp_path)


@pytest.mark.parametrize("name", PREFETCH)
def test_prefetch_through_both(name, tmp_path):
    run_in_both("test_prefetch", name, tmp_path)


@pytest.mark.parametrize("name", SCALEOUT_CACHE)
def test_result_cache_through_both(name, tmp_path):
    run_in_both("test_scaleout", name, tmp_path)


@pytest.mark.parametrize("name", LAZY + list(NATIVE_KV_ONLY))
def test_lazy_tablets_through_both_native_on(name, tmp_path):
    run_in_both("test_lazy_tablets", name, tmp_path, native=True)


@pytest.mark.parametrize("name", PREFETCH)
def test_prefetch_through_both_native_on(name, tmp_path):
    run_in_both("test_prefetch", name, tmp_path, native=True,
                ref_setup=drain_reference_prefetch)


@pytest.mark.parametrize("name", SCALEOUT_CACHE)
def test_result_cache_through_both_native_on(name, tmp_path):
    run_in_both("test_scaleout", name, tmp_path, native=True)


# -- PyKV --------------------------------------------------------------------

OPS = [("put", b"tab:a", b"x" * 40), ("put", b"meta:max_ts", b"17"),
       ("put", b"tab:b", bytes(range(256))), ("delete", b"tab:a", None),
       ("put", b"tab:c", b""), ("put", b"tab:b", b"again")]


def _drive_kv(kv_cls, d, ops, snapshot_at=None):
    kv = kv_cls(str(d))
    for i, (op, k, v) in enumerate(ops):
        kv.put(k, v) if op == "put" else kv.delete(k)
        if i == snapshot_at:
            kv.snapshot()
    kv.flush()
    kv.close()


@pytest.mark.parametrize("snapshot_at", [None, 2, 5])
def test_pykv_files_equal_and_cross_open(tmp_path, snapshot_at):
    """The same puts and deletes write the same SNAPSHOT.py and WAL
    bytes in both packages, and each package opens the other's store
    with the same contents."""
    _drive_kv(jkv.PyKV, tmp_path / "ref", OPS, snapshot_at)
    _drive_kv(tkv.PyKV, tmp_path / "port", OPS, snapshot_at)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    for mine, other in ((tkv.PyKV, "ref"), (jkv.PyKV, "port")):
        a = mine(str(tmp_path / other))
        b = (jkv.PyKV if mine is tkv.PyKV else tkv.PyKV)(
            str(tmp_path / other))
        assert list(a.scan()) == list(b.scan())
        assert dict(a.scan(b"tab:")) == {b"tab:b": b"again", b"tab:c": b""}
        assert len(a) == len(b) == 3
        a.close()
        b.close()


@pytest.mark.parametrize("kv_cls", [jkv.PyKV, tkv.PyKV], ids=["ref", "port"])
def test_pykv_checkpoint_compacts(tmp_path, kv_cls, monkeypatch):
    """PyKV's compaction (the counterpart of the reference's NativeKV
    test_checkpoint_compacts_store): a store-backed engine's checkpoint
    leaves one snapshot and an empty log, and the store still serves.
    Both packages write the same bytes (runtime off in both)."""
    switch_native(monkeypatch, False)
    outs = {}
    for side, G, kw in (("ref", JDB, {}), ("port", TDB, {"device": "cpu"})):
        d = tmp_path / side / "store"
        db = G(prefer_device=False, store_dir=str(d), tablet_budget=10_000,
               **kw)
        db.mutate(set_nquads="\n".join(
            f'<{i:#x}> <p{i % 8}> "v{i}" .' for i in range(1, 400)))
        db.rollup_all()
        db.checkpoint()
        assert not list(_PyWal(str(d / "WAL")).replay())
        assert os.path.getsize(d / "SNAPSHOT.py") > 0
        assert db.query('{ q(func: uid(0x7)) { p7 } }')["data"]["q"] == \
            [{"p7": "v7"}]
        db.close()
        outs[side] = {k: v for k, v in _tree(d).items()
                      if k != "coststore.json"}
    assert outs["port"] == outs["ref"]
    kv = kv_cls(str(tmp_path / "port" / "store"))
    assert sorted(k for k, _ in kv.scan(b"tab:")) == \
        [f"tab:p{i}".encode() for i in range(8)]
    kv.close()


@pytest.mark.parametrize("kv_cls", [jkv.PyKV, tkv.PyKV], ids=["ref", "port"])
def test_pykv_crash_between_snapshot_and_truncate(tmp_path, kv_cls):
    """PyKV's crash window (the counterpart of the reference's NativeKV
    compaction-crash test): a crash after the snapshot landed but
    before the log was truncated replays the log over the snapshot,
    which resurrects no deleted key."""
    d = tmp_path / "kv"
    kv = kv_cls(str(d))
    kv.put(b"dead", b"x" * 1500)
    kv.delete(b"dead")
    kv.put(b"live", b"y" * 1500)
    kv.flush()
    wal = (d / "WAL").read_bytes()
    kv.snapshot()
    kv.close()
    (d / "WAL").write_bytes(wal)          # the truncate never happened
    kv2 = kv_cls(str(d))
    assert kv2.get(b"dead") is None
    assert kv2.get(b"live") == b"y" * 1500
    assert len(kv2) == 1
    kv2.close()


# -- storage/uri -------------------------------------------------------------


def test_file_handler_equal(tmp_path):
    for side, mod in (("ref", juri), ("port", turi)):
        h = mod.new_uri_handler(f"file://{tmp_path / side}/bk")
        assert isinstance(h, mod.FileHandler)
        assert h.get("missing") is None
        h.put("a.bin", b"\x00\x01payload")
        h.put("a.bin", b"\x00\x02payload")
        assert h.get("a.bin") == b"\x00\x02payload"
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")


@pytest.mark.parametrize("dest", [
    "s3://bucket/some/prefix", "minio://127.0.0.1:9000/bkt/p1",
    "minio://127.0.0.1:9000/bkt?secure=true", "/plain/path",
    "gs://nope/path", "s3:///nobucket"])
def test_new_uri_handler_dispatch_equal(dest, monkeypatch):
    monkeypatch.setenv("AWS_ENDPOINT", "s3.example.test")
    got = []
    for mod in (juri, turi):
        try:
            h = mod.new_uri_handler(dest)
            got.append((type(h).__name__, {k: v for k, v in vars(h).items()}))
        except ValueError as e:
            got.append(("ValueError", str(e)))
    assert got[1] == got[0]


class _RecordingS3:
    """A local S3 endpoint that records every request (method, path,
    headers, body): GET/PUT under /bucket/key, 404 on a miss."""

    def __init__(self):
        objects = self.objects = {}
        requests = self.requests = []

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _record(self, body=b""):
                hdrs = {k.lower(): v for k, v in self.headers.items()
                        if k.lower() not in ("host", "user-agent")}
                requests.append((self.command, self.path, hdrs, body))

            def do_GET(self):
                self._record()
                body = objects.get(self.path)
                if body is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_PUT(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                self._record(body)
                objects[self.path] = body
                self.send_response(200)
                self.end_headers()

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class _FixedClock:
    """Stands in for `datetime` in a uri module: now() is one instant."""

    @staticmethod
    def now(tz=None):
        import datetime as _dt
        return _dt.datetime(2026, 10, 17, 12, 34, 56, tzinfo=tz)


@pytest.mark.parametrize("signed", [True, False])
def test_s3_handler_requests_equal(signed, monkeypatch):
    """S3Handler against a local recording endpoint with a fixed clock:
    both packages send the same requests, SigV4 headers included, and
    read back the same objects."""
    if signed:
        monkeypatch.setenv("AWS_ACCESS_KEY_ID", "minio-access")
        monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "minio-secret")
    else:
        monkeypatch.delenv("AWS_ACCESS_KEY_ID", raising=False)
        monkeypatch.delenv("AWS_SECRET_ACCESS_KEY", raising=False)
    runs = []
    srv = _RecordingS3()        # one endpoint: the host is signed
    try:
        for mod in (juri, turi):
            monkeypatch.setattr(mod, "datetime", _FixedClock)
            srv.objects.clear()
            del srv.requests[:]
            h = mod.new_uri_handler(
                f"minio://127.0.0.1:{srv.port}/dgraph-bk/run 1")
            h.put("manifest.json", b"[]")
            h.put("backup-0-5.gz", bytes(range(200)))
            got = (h.get("manifest.json"), h.get("backup-0-5.gz"),
                   h.get("absent"))
            runs.append((got, list(srv.requests)))
    finally:
        srv.close()
    assert runs[1] == runs[0]
    (manifest, blob, absent), reqs = runs[0]
    assert (manifest, blob, absent) == (b"[]", bytes(range(200)), None)
    auth = [hd.get("authorization", "") for _, _, hd, _ in reqs]
    assert all(a.startswith("AWS4-HMAC-SHA256") for a in auth) == signed
    assert all(p.startswith("/dgraph-bk/run%201/") for _, p, _, _ in reqs)


def test_sigv4_equal():
    for args in (("PUT", "h:9000", "/b/k", b"body", "ak", "sk", "us-east-1"),
                 ("GET", "s3.amazonaws.com", "/b/a%20b", b"", "A", "S",
                  "eu-west-2")):
        orig = juri.datetime, turi.datetime
        juri.datetime = turi.datetime = _FixedClock
        try:
            assert turi._sigv4(*args) == juri._sigv4(*args)
        finally:
            juri.datetime, turi.datetime = orig


# -- storage/bulkseed --------------------------------------------------------

SEED_RNG = np.random.default_rng(20261017)
SEED_U = np.sort(SEED_RNG.choice(np.arange(1, 1 << 20, dtype=np.uint64),
                                 3000, replace=False))


def _seed_blobs(seed):
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 50, len(SEED_U))
    labels = ["red", "green", "blue", "über"]
    codes = rng.integers(0, len(labels), len(SEED_U))
    deg = rng.integers(0, 6, 500)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    dsts = np.concatenate([np.sort(rng.choice(SEED_U, d, replace=False))
                           for d in deg])
    return [
        ("score", seed.int_tablet_blob("score: int @index(int) .",
                                       SEED_U, vals, 5)),
        ("tier", seed.str_tablet_blob("tier: string @index(exact) .",
                                      SEED_U, labels, codes, 5)),
        ("follow", seed.uid_tablet_blob("follow: [uid] .", SEED_U[:500],
                                        indptr, dsts, 5)),
    ]


def test_bulkseed_blobs_equal():
    ref, port = _seed_blobs(jseed), _seed_blobs(tseed)
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (p, a), (_, b) in zip(ref, port):
        assert b == a, p


def test_seed_store_serves_in_both(tmp_path, monkeypatch):
    """seed_store into each package's TabletStore writes the same store
    bytes, and the port's engine on the seeded store answers as the
    reference's (runtime off: PyKV)."""
    switch_native(monkeypatch, False)
    seed_store_serves_in_both(tmp_path)


def test_seed_store_serves_in_both_native_on(tmp_path):
    """The same on NativeKV, the runtime on in both packages."""
    seed_store_serves_in_both(tmp_path)


def seed_store_serves_in_both(tmp_path):
    schema = ("score: int @index(int) .\ntier: string @index(exact) .\n"
              "follow: [uid] .")
    for side, lazy, seed in (("ref", jlazy, jseed), ("port", tlazy, tseed)):
        d = tmp_path / side
        store = lazy.TabletStore(str(d)) if side == "ref" \
            else lazy.TabletStore(str(d), "cpu")
        n = seed.seed_store(store, schema, _seed_blobs(seed), 6)
        assert n == sum(len(b) for _, b in _seed_blobs(seed))
        store.compact()
        store.close()
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    qs = ['{ q(func: eq(tier, "über"), first: 7) { uid score } }',
          '{ q(func: ge(score, 45), first: 5) { uid tier } }',
          '{ q(func: has(follow), first: 3) { uid follow { uid } } }']
    out = {}
    for side, G, kw in (("ref", JDB, {}), ("port", TDB, {"device": "cpu"})):
        db = G(prefer_device=False, store_dir=str(tmp_path / side), **kw)
        out[side] = [db.query(q)["data"] for q in qs]
        db.close()
    assert out["port"] == out["ref"]
    assert all(out["ref"])


# -- tiles, eviction and device placement ------------------------------------


def _store_engine(tmp_path, **kw):
    db = TDB(prefer_device=True, device_min_edges=1, device="cpu",
             store_dir=str(tmp_path / "store"), **kw)
    db.alter("friend: [uid] @reverse .\nname: string @index(exact) .")
    db.mutate(set_nquads="\n".join(
        [f"<{u:#x}> <friend> <{(u * 7) % 97 + 1:#x}> ." for u in range(1, 97)]
        + [f'<{u:#x}> <name> "n{u % 5}" .' for u in range(1, 97)]))
    db.rollup_all(0)
    return db


def test_evict_then_reload_rebuilds_tiles(tmp_path):
    """An offloaded tablet's tiles leave the tile budget with it; the
    reloaded tablet (a new object, which may reuse the evicted one's
    id) builds its tiles afresh, equal to the first, never serving the
    evicted ones."""
    from dgraph_tpu_torch.engine import device_cache as dc
    db = _store_engine(tmp_path)
    ts = db.coordinator.max_assigned()
    old = db.tablets["friend"]
    first = dc.device_adjacency(db, old, ts)
    assert first is not None and db.device_cache.bytes > 0
    key = (id(old), "_device_adj")
    assert key in db.device_cache._entries
    assert db.tablets.offload("friend")
    assert key not in db.device_cache._entries
    assert db.device_cache.bytes == 0
    del old, first
    new = db.tablets["friend"]
    assert new._device_adj is None
    again = dc.device_adjacency(db, new, ts)
    assert (id(new), "_device_adj") in db.device_cache._entries
    want = dc.device_adjacency(db, db.tablets["friend"], ts)
    assert again is want
    q = '{ q(func: uid(0x3)) { friend { uid ~friend { uid } } } }'
    host = TDB(prefer_device=False, device="cpu")
    host.alter("friend: [uid] @reverse .\nname: string @index(exact) .")
    host.mutate(set_nquads="\n".join(
        f"<{u:#x}> <friend> <{(u * 7) % 97 + 1:#x}> ." for u in range(1, 97)))
    assert db.query(q)["data"] == host.query(q)["data"]
    db.close()


def test_store_tablets_land_on_the_engine_device(tmp_path, monkeypatch):
    """Every tablet a store-backed engine materializes (synchronous
    load, prefetch worker) is on the engine's device; a store without a
    device asks for the card, which raises here."""
    db = _store_engine(tmp_path)
    db.close()
    db = TDB(store_dir=str(tmp_path / "store"), prefetch_workers=2,
             device="cpu")
    assert db.tablets["name"].device == torch.device("cpu")
    assert db.prefetcher.schedule(db, ["friend"]) == 1
    assert db.prefetcher.take("friend", None).device == torch.device("cpu")
    db.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlazy.TabletStore(str(tmp_path / "other"))


def test_worker_decode_equals_engine_thread_decode(tmp_path):
    """A vector tablet decoded on a prefetch worker is the tablet the
    engine thread restores: equal dump_tablet bytes, its trained index
    included."""
    db = TDB(store_dir=str(tmp_path / "store"), device="cpu",
             vec_index_min_rows=256)
    db.alter("emb: float32vector @index(vector) .")
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((600, 8)).astype(np.float32)
    db.mutate(set_json=[{"uid": hex(i + 1), "emb": "[" + ",".join(
        "%.9g" % x for x in v) + "]"} for i, v in enumerate(vecs)])
    db.rollup_all(0)
    assert db.tablets["emb"].vector_ivf() is not None
    db.close()
    db = TDB(store_dir=str(tmp_path / "store"), device="cpu",
             prefetch_workers=1, vec_index_min_rows=256)
    assert db.prefetcher.schedule(db, ["emb"]) == 1
    worker = db.prefetcher.take("emb", None)
    sync = db.tablet_store.load("emb", db.schema)
    assert worker is not None and worker.vector_ivf() is not None
    assert twire.dumps(tsnap.dump_tablet(worker)) == \
        twire.dumps(tsnap.dump_tablet(sync))
    db.close()


# -- the engine's options against the reference's ----------------------------


def test_state_and_debug_stats_carry_cold_fields(tmp_path):
    outs = {}
    for side, G, kw in (("ref", JDB, {}), ("port", TDB, {"device": "cpu"})):
        db = G(prefer_device=False, store_dir=str(tmp_path / side),
               prefetch_workers=2, result_cache_entries=8, **kw)
        db.alter("name: string @index(exact) .")
        db.mutate(set_nquads='<0x1> <name> "a" .')
        db.query('{ q(func: eq(name, "a")) { name } }')
        db.query('{ q(func: eq(name, "a")) { name } }')
        st = db.debug_stats()
        outs[side] = (st["resultCache"]["entries"],
                      sorted(st["prefetch"]), st["prefetch"]["workers"])
        db.close()
    assert outs["port"] == outs["ref"] == (1, sorted(outs["ref"][1]), 2)


def test_columnar_parity_result_cache_arm(monkeypatch):
    """tests/test_columnar_parity.py's cached arm on the port: the fill
    and the hit pass give the reference postings oracle's bytes, and
    the hit pass serves from the cache."""
    from tests import test_columnar_parity as cp
    oracle = cp._run_all(cp._build(False))
    monkeypatch.setattr(cp, "GraphDB", CpuGraphDB)
    cached = cp._build(True, prefer_compressed=True,
                       result_cache_entries=256)
    before = tmetrics.counters_snapshot()
    fill = cp._run_all(cached)
    hit = cp._run_all(cached)
    delta = tmetrics.counters_delta(before)
    assert delta.get("dgraph_result_cache_hits_total", 0) > 0
    assert fill == oracle and hit == oracle
