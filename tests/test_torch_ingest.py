"""The port's ingest (dgraph_tpu_torch/ingest: chunker, xidmap, bulk
and live loaders, export, the SQL and GeoJSON converters) against the
reference's, on the CPU.

The 13 tests of tests/test_ingest.py that need no server run through
both packages (tests/test_torch_cold_storage.py's `run_in_both`): every
engine each pass builds must end with the same dump_tablet bytes, the
reference's bulk map taking its Python grammar (native off), as the
port always does. `test_bulk_native_parser_matches_python` becomes the
port's bulk load against the reference's native columnar map where
that builds. The three `remote_live_load` tests need the HTTP server
(ROADMAP Queue 1 item 10); `remote_live_load` is held here against the
reference's requests through a local recording endpoint instead.
"""

from __future__ import annotations

import io
import json
import sqlite3
import threading
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import dgraph_tpu.native
from dgraph_tpu import wire as jwire
from dgraph_tpu.engine.db import GraphDB as JDB
from dgraph_tpu.ingest import bulk as jbulk, convert as jconv
from dgraph_tpu.ingest import export as jexport, live as jlive
from dgraph_tpu.storage import snapshot as jsnap
from dgraph_tpu_torch import wire as twire
from dgraph_tpu_torch.engine.db import GraphDB as TDB
from dgraph_tpu_torch.ingest import bulk as tbulk, convert as tconv
from dgraph_tpu_torch.ingest import export as texport, live as tlive
from dgraph_tpu_torch.storage import snapshot as tsnap
from tests.test_torch_cold_storage import reference_cases, run_in_both

SERVER = ("test_remote_live_load_into_running_alpha",
          "test_remote_live_load_datetime_facet",
          "test_remote_live_load_xid_subjects",
          "test_bulk_native_parser_matches_python")
# batches commit from 4 threads: commit order (so the ts of each
# delta) is the scheduler's
CONCURRENT = ("test_live_load_conflict_retry",)
INGEST = reference_cases("test_ingest", SERVER)


def test_the_reference_file_holds_its_cases():
    assert len(INGEST) == 13
    assert len(reference_cases("test_ingest")) == 17


@pytest.mark.parametrize("name", INGEST)
def test_ingest_through_both(name, tmp_path):
    run_in_both("test_ingest", name, tmp_path,
                dumps=name not in CONCURRENT)


def _dumps(db, snap, wire):
    return {p: wire.dumps(snap.dump_tablet(t))
            for p, t in sorted(db.tablets.items())}


MIXED = """
<0x1> <name> "Alice" .
<0x1> <name> "Alicia"@es .
<0x2> <name> "Bob \\"quoted\\"" .
<0x1> <friend> <0x2> (since=2020, close=true) .
<0x2> <friend> <0x3> .
<0x4> <score> "3.5"^^<xs:float> .
<0x5> <name> "Café Unicode" .
<0x6> <aka> "One" (kind="working") .
<0x6> <aka> "Two" .
<10> <name> "DecimalUid" .
_:blank <name> "Blanky" .
<0x3> <owns> _:blank .
""".strip() + "\n"
MIXED_SCHEMA = ('name: string @index(term, exact) @lang .\n'
                'aka: [string] .\nfriend: [uid] @reverse .\n'
                'owns: uid .\nscore: float .')


def test_bulk_equals_reference_native_map(tmp_path):
    """The port's Python map against the reference's native columnar map
    (tests/test_ingest.py's mixed input): equal tablets, and equal
    dump_tablet bytes to the reference's Python map."""
    rdf = tmp_path / "mix.rdf"
    rdf.write_text(MIXED)
    t = tbulk.bulk_load([str(rdf)], schema=MIXED_SCHEMA, device="cpu")
    want = _dumps(t, tsnap, twire)
    if dgraph_tpu.native.available():
        nat = jbulk.bulk_load([str(rdf)], schema=MIXED_SCHEMA,
                              db=JDB(prefer_device=False))
        assert sorted(nat.tablets) == sorted(t.tablets)
        for pred in nat.tablets:
            a, b = nat.tablets[pred], t.tablets[pred]
            assert {u: v.tolist() for u, v in a.edges.items()} == \
                {u: v.tolist() for u, v in b.edges.items()}, pred
            assert repr(sorted(a.values.items())) == \
                repr(sorted(b.values.items())), pred
            assert {k: v.tolist() for k, v in a.index.items()} == \
                {k: v.tolist() for k, v in b.index.items()}, pred
    orig = dgraph_tpu.native.available
    dgraph_tpu.native.available = lambda: False
    try:
        py = jbulk.bulk_load([str(rdf)], schema=MIXED_SCHEMA,
                             db=JDB(prefer_device=False))
    finally:
        dgraph_tpu.native.available = orig
    assert want == _dumps(py, jsnap, jwire)


def test_bulk_offloads_into_a_store_alike(tmp_path, monkeypatch):
    """bulk_load into a store-backed engine offloads each predicate as
    its reduce finishes: equal store files, and equal export lines."""
    monkeypatch.setattr(dgraph_tpu.native, "available", lambda: False)
    rdf = tmp_path / "mix.rdf"
    rdf.write_text(MIXED)
    lines = {}
    for side, G, bulk, exp, kw in (
            ("ref", JDB, jbulk, jexport, {}),
            ("port", TDB, tbulk, texport, {"device": "cpu"})):
        db = G(prefer_device=False, store_dir=str(tmp_path / side),
               tablet_budget=1, **kw)
        bulk.bulk_load([str(rdf)], schema=MIXED_SCHEMA, db=db)
        assert not dict.keys(db.tablets)
        lines[side] = (list(exp.export_rdf(db)), exp.export_schema(db),
                       exp.export_json(db))
        db.checkpoint()
        db.close()
    assert lines["port"] == lines["ref"]
    for name in ("SNAPSHOT.py", "WAL"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name


def test_bulk_shard_outputs_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(dgraph_tpu.native, "available", lambda: False)
    rdf = tmp_path / "mix.rdf"
    rdf.write_text(MIXED)
    ref = jbulk.bulk_load([str(rdf)], schema=MIXED_SCHEMA,
                          db=JDB(prefer_device=False))
    port = tbulk.bulk_load([str(rdf)], schema=MIXED_SCHEMA, device="cpu")
    mr = jbulk.bulk_shard_outputs(ref, 3, str(tmp_path / "ref"))
    mp = tbulk.bulk_shard_outputs(port, 3, str(tmp_path / "port"))
    assert mp == mr
    for g in (1, 2, 3):
        assert (tmp_path / "port" / f"g{g}" / "p.snap").read_bytes() == \
            (tmp_path / "ref" / f"g{g}" / "p.snap").read_bytes()
    assert (tmp_path / "port" / "manifest.json").read_bytes() == \
        (tmp_path / "ref" / "manifest.json").read_bytes()


LIVE_SIDES = {"ref": (JDB, jlive, jsnap, jwire, {}),
              "port": (TDB, tlive, tsnap, twire, {"device": "cpu"})}
# the highest explicit uid of MIXED (<10>)
MIXED_MAX_UID = 10


class _StageFirst:
    """An executor that runs each batch as it is submitted: every batch
    is staged before the loader resolves the next one."""

    def __init__(self, max_workers=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args):
        fut = Future()
        fut.set_result(fn(*args))
        return fut


def _live_dumps(side, rdf, schedule=None, monkeypatch=None):
    """(stats, dumps) of `side`'s live loader over `rdf` (transactions
    of 3, one worker so commits keep file order).

    The loader leases a blank node's uid on the caller's thread while
    its worker stages the batches before it, and staging an explicit
    uid bumps the lease counter: without a fixed start, where `_:blank`
    lands depends on which thread ran first. So the uid counter starts
    past the file's explicit uids in both passes. `schedule` forces the
    order: "stage_first" stages each batch before the next is resolved,
    "lease_first" holds the first staging until a blank uid is leased."""
    G, live, snap, wire, kw = LIVE_SIDES[side]
    db = G(prefer_device=False, **kw)
    db.coordinator.bump_uids(MIXED_MAX_UID)
    if schedule == "stage_first":
        monkeypatch.setattr(live, "ThreadPoolExecutor", _StageFirst)
    elif schedule == "lease_first":
        leased = threading.Event()
        stage = db._stage

        class Told(live.XidMap):
            def assign(self, xid):
                uid = super().assign(xid)
                leased.set()
                return uid

        def stage_after_lease(txn, nqs):
            assert leased.wait(30), "no blank uid was leased"
            return stage(txn, nqs)
        monkeypatch.setattr(live, "XidMap", Told)
        db._stage = stage_after_lease
    stats = live.live_load(db, [str(rdf)], schema=MIXED_SCHEMA,
                           batch_size=3, concurrency=1)
    db.rollup_all(0)
    return stats, _dumps(db, snap, wire)


def test_live_load_matches_bulk_in_both(tmp_path):
    """The live loader gives the same dumps in both packages."""
    rdf = tmp_path / "mix.rdf"
    rdf.write_text(MIXED)
    assert _live_dumps("port", rdf) == _live_dumps("ref", rdf)


@pytest.mark.parametrize("orders", [("stage_first", "lease_first"),
                                    ("lease_first", "stage_first")])
def test_live_load_twin_holds_under_either_schedule(tmp_path, monkeypatch,
                                                    orders):
    """The two passes raced apart: one staged its explicit uids before
    the blank's lease, the other after. The dumps stay equal."""
    rdf = tmp_path / "mix.rdf"
    rdf.write_text(MIXED)
    ref = _live_dumps("ref", rdf, orders[0], monkeypatch)
    monkeypatch.undo()
    assert _live_dumps("port", rdf, orders[1], monkeypatch) == ref


# -- remote_live_load against a recording endpoint ---------------------------


class _RecordingAlpha:
    """Answers /alter, /assign and /mutate as an alpha would, and
    records each request's path, content type and body."""

    def __init__(self, abort_first: int = 0):
        self.requests = []
        self.next_uid = 1
        self.aborts = abort_first
        lock = threading.Lock()
        rec = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                with lock:
                    rec.requests.append(
                        (self.path, self.headers.get("Content-Type"),
                         self.headers.get("X-Dgraph-AccessToken"), body))
                    if self.path.startswith("/assign"):
                        num = int(self.path.split("num=")[1])
                        out = {"startId": rec.next_uid,
                               "endId": rec.next_uid + num - 1}
                        rec.next_uid += num
                    elif self.path.startswith("/mutate") and rec.aborts:
                        rec.aborts -= 1
                        self.send_response(409)
                        self.end_headers()
                        return
                    else:
                        out = {"data": {"code": "Success"}}
                data = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


REMOTE = """\
_:alice <name> "Alice" .
_:alice <age> "25"^^<xs:int> .
_:bob <name> "Bob" .
_:alice <friend> _:bob (since=2020-01-02T03:04:05) .
<0x10> <name> "Explicit" .
<person-7> <name> "xid subject"@en .
<0x10> <friend> <person-7> .
_:carl <tags> "a\\"b" .
"""


@pytest.mark.parametrize("aborts", [0, 2])
def test_remote_live_load_requests_equal(tmp_path, aborts):
    """remote_live_load sends the same requests from both packages
    (one worker: batch order is file order), abort retries included."""
    rdf = tmp_path / "d.rdf"
    rdf.write_text(REMOTE)
    runs = []
    for live in (jlive, tlive):
        srv = _RecordingAlpha(abort_first=aborts)
        try:
            stats = live.remote_live_load(
                srv.addr, [str(rdf)], schema="name: string @index(exact) .",
                batch_size=3, concurrency=1, token="tok")
        finally:
            srv.close()
        runs.append((stats, srv.requests))
    assert runs[1] == runs[0]
    stats, reqs = runs[0]
    assert stats == {"nquads": 8, "txns": 3, "aborts": aborts}
    assert [p for p, *_ in reqs][:2] == ["/alter", "/assign?num=10000"]
    assert all(b"_:" not in body for p, _, _, body in reqs
               if p.startswith("/mutate"))


# -- the converters ----------------------------------------------------------


def _sqlite(path):
    conn = sqlite3.connect(path)
    conn.executescript("""
    CREATE TABLE dept (id INTEGER PRIMARY KEY, name TEXT, budget REAL);
    CREATE TABLE emp (id INTEGER PRIMARY KEY, name TEXT, hired DATE,
                      active BOOLEAN, dept_id INTEGER REFERENCES dept(id),
                      photo BLOB);
    CREATE TABLE pair (a TEXT, b TEXT, note TEXT, PRIMARY KEY (a, b));
    CREATE TABLE link (x TEXT, y TEXT, FOREIGN KEY (x, y)
                       REFERENCES pair(a, b));
    CREATE TABLE loose (v TEXT REFERENCES emp(name));
    INSERT INTO dept VALUES (1, 'R&D', 1.5e6), (2, 'Sales "West"', NULL);
    INSERT INTO emp VALUES (1, 'John Smith', '2020-01-02', 1, 1, x'00ff'),
                           (2, 'John_Smith', NULL, 0, 2, NULL),
                           (3, 'Zoë', '2021-05-06', 1, NULL, NULL);
    INSERT INTO pair VALUES ('p q', 'r', 'n1'), ('s', 't/u', 'n2');
    INSERT INTO link VALUES ('p q', 'r'), ('s', NULL);
    INSERT INTO loose VALUES ('John Smith');
    """)
    conn.commit()
    conn.close()


@pytest.mark.parametrize("sep", [".", "_"])
def test_migrate_sqlite_equal(tmp_path, sep):
    path = str(tmp_path / "src.db")
    _sqlite(path)
    outs = []
    for conv in (jconv, tconv):
        rdf, schema = io.StringIO(), io.StringIO()
        stats = conv.migrate_sqlite(path, rdf, schema, separator=sep)
        outs.append((stats, rdf.getvalue(), schema.getvalue()))
    assert outs[1] == outs[0]
    assert outs[0][0]["rows"] == 10 and outs[0][0]["skipped_fks"] >= 1


@pytest.mark.parametrize("doc", [
    {"type": "FeatureCollection", "features": [
        {"type": "Feature", "geometry": {"type": "Point",
                                         "coordinates": [1.5, -2]},
         "properties": {"name": "A \"q\"", "pop count": 7, "skip": None,
                        "nested": {"x": 1}, "ok": True}},
        {"type": "Feature", "geometry": None, "properties": {"n": 1}},
        {"type": "Feature", "geometry": {
            "type": "Polygon",
            "coordinates": [[[0, 0], [1, 0], [1, 1], [0, 0]]]},
         "properties": {}}]},
    {"type": "Feature", "geometry": {"type": "Point",
                                     "coordinates": [3, 4]}},
])
def test_convert_geojson_equal(doc):
    outs = []
    for conv in (jconv, tconv):
        out = io.StringIO()
        stats = conv.convert_geojson(io.StringIO(json.dumps(doc)), out,
                                     geopred="place loc")
        outs.append((stats, out.getvalue()))
    assert outs[1] == outs[0]
    assert outs[0][0]["features"] >= 1


def test_vector_export_round_trips(tmp_path):
    """export_rdf writes float32vectors that reload bit for bit (nine
    significant digits an element); every other line is the
    reference's. The reference's numpy str() keeps at most eight
    fractional digits, so its reload changes most rows of a unit-scale
    corpus (a decided difference, ingest/export.py)."""
    rng = np.random.default_rng(5)
    vecs = (rng.standard_normal((64, 16)) * 0.01).astype(np.float32)
    lits = ["[" + ",".join("%.9g" % x for x in v) + "]" for v in vecs]
    out = {}
    for side, G, exp, kw in (("ref", JDB, jexport, {}),
                             ("port", TDB, texport, {"device": "cpu"})):
        db = G(prefer_device=False, **kw)
        db.alter("emb: float32vector .\nname: string .")
        db.mutate(set_json=[{"uid": hex(i + 1), "emb": lit, "name": f"n{i}"}
                            for i, lit in enumerate(lits)])
        out[side] = list(exp.export_rdf(db))
    assert [ln for ln in out["port"] if "<emb>" not in ln] == \
        [ln for ln in out["ref"] if "<emb>" not in ln]
    path = tmp_path / "port.rdf"
    path.write_text("\n".join(out["port"]) + "\n")
    back = tbulk.bulk_load([str(path)], schema="emb: float32vector .",
                           device="cpu")
    got = np.stack([back.tablets["emb"].values[i + 1][0].value.value
                    for i in range(len(vecs))])
    np.testing.assert_array_equal(got, vecs)
    assert list(texport.export_rdf(back)) == out["port"]
