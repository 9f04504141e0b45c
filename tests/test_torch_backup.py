"""The port's backup, restore and point-in-time restore
(dgraph_tpu_torch/storage/backup.py) against the reference's, on the
CPU.

The reference's tests/test_backup.py (9 tests) and tests/test_pitr.py
run through both packages as tests/test_torch_cold_storage.py's
`run_in_both` runs them: each pass in its own directory, and each with
its own fake S3 endpoint (the reference's, copied here), whose objects
must be equal afterwards as the files are: backup artifacts by their
gzip contents, manifests apart from `unix_ts`, encrypted artifacts by
length. `test_cli_restore_to_ts` drives the command line, which is not
ported yet (ROADMAP Queue 1 item 10).

Then a vector tablet's round trip: a store-backed engine trains its
IVF index on the CPU in both packages with equal store bytes; reopened
from the store and restored from a backup, the port answers the
quantized tier as the reference does, and trains no index again.
"""

from __future__ import annotations

import gzip
import http.server
import json
import threading

import numpy as np
import pytest
import torch

import dgraph_tpu.native
from dgraph_tpu.engine.db import GraphDB as JDB
from dgraph_tpu.storage import backup as jbk
from dgraph_tpu_torch import wire as twire
from dgraph_tpu_torch.engine.db import GraphDB as TDB
from dgraph_tpu_torch.ops import ivf as tivf
from dgraph_tpu_torch.storage import backup as tbk
from dgraph_tpu_torch.storage import snapshot as tsnap
from tests.test_torch_cold_storage import _tree, reference_cases, run_in_both

ENCRYPTED = ("test_encrypted_backup_requires_key", "test_minio_encrypted_chain",
             "test_encrypted_wal_roundtrip")
BACKUP = reference_cases("test_backup")
PITR = reference_cases("test_pitr", ("test_cli_restore_to_ts",))


class _FakeS3(object):
    """In-process S3-compatible object store (tests/test_backup.py's):
    GET/PUT on /bucket/key paths, 404 on misses."""

    def __init__(self):
        store = self.objects = {}

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                body = store.get(self.path)
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
                store[self.path] = self.rfile.read(n)
                self.auth = self.headers.get("Authorization", "")
                store["__last_auth__"] = self.auth.encode()
                self.send_response(200)
                self.end_headers()

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def fake_s3():
    srv = _FakeS3()
    yield srv
    srv.close()


def _objects(args, encrypted: bool):
    """The fake endpoint's objects, comparable across the passes (the
    SigV4 header carries the wall clock and is left out)."""
    srv = args.get("fake_s3")
    if srv is None:
        return None
    out = {}
    for path, data in srv.objects.items():
        if path == "__last_auth__":
            out[path] = data[:16]
        elif path.endswith("manifest.json"):
            out[path] = [{k: v for k, v in e.items() if k != "unix_ts"}
                         for e in json.loads(data)]
        elif encrypted:
            out[path] = len(data)
        else:
            out[path] = gzip.decompress(data)
    return out


def test_the_reference_files_hold_their_cases():
    assert len(BACKUP) == 9
    assert PITR == ["test_restore_to_ts_byte_parity_vs_wal_oracle",
                    "test_restore_to_boundary_matches_plain_restore",
                    "test_restore_past_chain_head_refused",
                    "test_pitr_coverage_error_when_ring_evicted"]


@pytest.mark.parametrize("name", BACKUP)
def test_backup_through_both(name, tmp_path):
    encrypted = name in ENCRYPTED
    opaque = ("wal",) if encrypted else ()
    if encrypted:
        # AES-GCM seals each artifact under a fresh nonce
        opaque += tuple(f"backup-0-{ts}.gz" for ts in range(1, 64))
    run_in_both("test_backup", name, tmp_path, opaque=opaque,
                fixtures={"fake_s3": fake_s3},
                collect=lambda args: _objects(args, encrypted))


@pytest.mark.parametrize("name", PITR)
def test_pitr_through_both(name, tmp_path):
    run_in_both("test_pitr", name, tmp_path)


# -- a vector tablet through the store and a backup --------------------------

DIM = 8
ROWS = 600


def _vectors():
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    queries = rng.standard_normal((6, DIM)).astype(np.float32)
    return vecs, queries


def _lit(v) -> str:
    return "[" + ",".join("%.9g" % x for x in v) + "]"


def _similar(db, queries):
    return [db.query('{ q(func: similar_to(emb, 5, "%s")) '
                     '{ uid s: val(similar_to_score) } }' % _lit(q))["data"]
            for q in queries]


def _engine(G, store, **kw):
    return G(prefer_device=False, store_dir=store, vec_index_min_rows=256,
             planner="static", **kw)


def test_vector_index_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(dgraph_tpu.native, "available", lambda: False)
    vecs, queries = _vectors()
    answers = {}
    for side, G, bk, kw in (("ref", JDB, jbk, {}),
                            ("port", TDB, tbk, {"device": "cpu"})):
        store = str(tmp_path / side / "store")
        db = _engine(G, store, **kw)
        db.alter("emb: float32vector @index(vector) .")
        db.mutate(set_json=[{"uid": hex(i + 1), "emb": _lit(v)}
                            for i, v in enumerate(vecs)])
        db.rollup_all(0)
        assert db.tablets["emb"].vector_ivf() is not None
        fresh = _similar(db, queries)
        db.checkpoint()
        db.close()
        if side == "port":
            # no index is trained from here on: it comes from the blobs
            monkeypatch.setattr(tivf, "build", None)
        db = _engine(G, store, **kw)
        reopened = _similar(db, queries)
        bk.backup(db, str(tmp_path / side / "bk"))
        db.close()
        restored = bk.restore(str(tmp_path / side / "bk"), db=G(
            prefer_device=False, vec_index_min_rows=256, planner="static",
            **kw))
        if side == "port":
            ix = restored.tablets["emb"].vector_ivf()
            assert ix is not None and ix.device == torch.device("cpu")
        answers[side] = (fresh, reopened, _similar(restored, queries))
        assert answers[side][1] == answers[side][0] == answers[side][2], side
    assert answers["port"] == answers["ref"]
    ref, port = _tree(tmp_path / "ref"), _tree(tmp_path / "port")
    assert sorted(port) == sorted(ref)
    for rel in ref:
        if not rel.endswith("coststore.json"):
            assert port[rel] == ref[rel], rel


def test_chain_restore_keeps_the_trained_index(tmp_path, monkeypatch):
    """A full and an incremental backup restored: the port's vector
    tablet keeps the index the full entry carried (its dump equals the
    source's, the quantized tier answers as the source's without
    training), where the reference's second entry re-alters the schema
    and drops it (a decided difference, storage/backup.py)."""
    monkeypatch.setattr(dgraph_tpu.native, "available", lambda: False)
    vecs, queries = _vectors()
    got = {}
    for side, G, bk, kw in (("ref", JDB, jbk, {}),
                            ("port", TDB, tbk, {"device": "cpu"})):
        db = _engine(G, str(tmp_path / side / "store"), **kw)
        db.alter("emb: float32vector @index(vector) .\nname: string .")
        db.mutate(set_json=[{"uid": hex(i + 1), "emb": _lit(v)}
                            for i, v in enumerate(vecs)])
        db.rollup_all(0)
        dest = str(tmp_path / side / "bk")
        bk.backup(db, dest)
        db.mutate(set_nquads='<0x1> <name> "n" .')
        bk.backup(db, dest)
        want = _similar(db, queries)
        restored = bk.restore(dest, db=G(
            prefer_device=False, vec_index_min_rows=256, planner="static",
            **kw))
        got[side] = restored.tablets["emb"].vector_ivf() is not None
        if side == "port":
            monkeypatch.setattr(tivf, "build", None)
            assert twire.dumps(tsnap.dump_tablet(restored.tablets["emb"])) \
                == twire.dumps(tsnap.dump_tablet(db.tablets["emb"]))
            assert _similar(restored, queries) == want
    assert got == {"ref": False, "port": True}
