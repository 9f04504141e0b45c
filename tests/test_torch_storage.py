"""The port's storage layer (dgraph_tpu_torch.storage: wal, enc,
snapshot, tabstats, vecstore, versions, and ops/codec's group-varint
wrappers) against the reference's, on the CPU.

State crosses both ways with equal bytes: a WAL written by either
package (the reference's native frames included, torn tails included)
replays into the other; a snapshot written by either loads into the
other, the reference's legacy v0 fixture included; the group-varint
streams, tablet statistics and the trained IVF payload equal the
reference's byte for byte."""

import gzip
import os
import struct

import numpy as np
import pytest

from dgraph_tpu import native as jnative
from dgraph_tpu import wire as jw
from dgraph_tpu.engine.db import GraphDB as JDB
from dgraph_tpu.ops import codec as jcodec
from dgraph_tpu.storage import snapshot as jsnap
from dgraph_tpu.storage import tabstats as jstats
from dgraph_tpu.storage import vecstore as jvec
from dgraph_tpu.storage import versions as jver
from dgraph_tpu.storage.wal import Wal as JWal
from dgraph_tpu_torch import native as tnative
from dgraph_tpu_torch import wire as tw
from dgraph_tpu_torch.engine.db import GraphDB as TDB
from dgraph_tpu_torch.ops import codec as tcodec
from dgraph_tpu_torch.storage import snapshot as tsnap
from dgraph_tpu_torch.storage import tabstats as tstats
from dgraph_tpu_torch.storage import vecstore as tvec
from dgraph_tpu_torch.storage import versions as tver
from dgraph_tpu_torch.storage.wal import _MAGIC, Wal as TWal

FIXTURE = os.path.join(os.path.dirname(__file__), "golden",
                       "legacy_snapshot_v0.snap")

SCHEMA = """
name: string @index(exact, term) @lang .
friend: [uid] @reverse @count .
age: int @index(int) .
tags: [string] @index(term) .
emb: float32vector .
"""

RDF = "\n".join([
    '_:a <name> "Alice" .', '_:a <name> "Alicia"@es .',
    '_:a <age> "31"^^<xs:int> .', '_:b <name> "Bob" .',
    '_:a <friend> _:b (since=2015) .', '_:b <friend> _:c .',
    '_:c <name> "Carol" .', '_:c <tags> "red" .', '_:c <tags> "blue" .',
    '_:a <emb> "[0.5, 1.0, -2.0]"^^<xs:float32vector> .',
])


def jdb(**kw):
    return JDB(plan_cache_size=0, **kw)


def tdb(**kw):
    return TDB(plan_cache_size=0, device="cpu", **kw)


def fill(db):
    """The same commits in either package: a schema, a batch, an
    overwrite, deletes (S P O, S P *) and a second rollup-free batch."""
    db.alter(SCHEMA)
    db.mutate(set_nquads=RDF)
    db.mutate(set_nquads='<0x1> <age> "32"^^<xs:int> .\n'
                         '<0x3> <friend> <0x1> .')
    db.mutate(del_nquads='<0x1> <friend> <0x2> .\n<0x3> <tags> * .')
    db.mutate(set_json=[{"uid": "0x2", "tags": ["green", "gold"]}])
    return db


def dumps_of(db, wire):
    dump = jsnap.dump_tablet if wire is jw else tsnap.dump_tablet
    return {p: wire.dumps(dump(t)) for p, t in sorted(db.tablets.items())}


# -- WAL ---------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_wal_crosses_with_equal_tablets(tmp_path, direction):
    path = str(tmp_path / "wal")
    if direction == "ref_to_port":
        a = fill(jdb(wal_path=path))
        a.close()
        b = tdb(wal_path=path)
        assert dumps_of(b, tw) == dumps_of(a, jw)
    else:
        a = fill(tdb(wal_path=path))
        a.close()
        b = jdb(wal_path=path)
        assert dumps_of(b, jw) == dumps_of(a, tw)
    b.close()


def test_reference_writes_native_frames_here():
    """The reference's WAL backend in these tests is its native one, so
    the crossing above reads native frames."""
    assert jnative.available()


def _frames(path):
    """(offset, length, payload) per framed record (u32 len | u32 crc |
    payload), as tests/test_wal_crash.py parses them."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    at = len(_MAGIC)
    while at + 8 <= len(data):
        n, _crc = struct.unpack_from("<II", data, at)
        out.append((at, 8 + n, data[at + 8:at + 8 + n]))
        at += 8 + n
    return out


def _torn_tail(path, frames):
    with open(path, "rb+") as f:
        f.truncate(frames[2][0] + frames[2][1] // 2)
    return 2, frames[2][0]


def _header_only_tail(path, frames):
    with open(path, "ab") as f:
        f.write(b"\x99\x00\x00")
    return 3, frames[2][0] + frames[2][1]


def _crc_corruption(path, frames):
    off = frames[1][0] + 8 + frames[1][1] // 3
    with open(path, "rb+") as f:
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ 0xFF]))
    return 1, frames[1][0]


def _corrupt_length(path, frames):
    with open(path, "rb+") as f:
        f.seek(frames[1][0])
        f.write(struct.pack("<I", 1 << 30))
    return 1, frames[1][0]


CRASHES = [_torn_tail, _header_only_tail, _crc_corruption, _corrupt_length]
WALS = {"ref": (JWal, jw), "port": (TWal, tw)}


@pytest.mark.parametrize("crash", CRASHES, ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"),
                                           ("port", "port")])
def test_wal_crash_recovery_crosses(tmp_path, crash, writer, reader):
    """tests/test_wal_crash.py's torn-tail and corruption cases, written
    by one package and recovered by the other: the same prefix replays,
    the file is truncated to the same length, and a post-recovery append
    replays in the writer's package."""
    path = str(tmp_path / "wal")
    records = [("rec", 1), ("rec", 2), ("rec", 3)]
    wcls, _ = WALS[writer]
    rcls, _ = WALS[reader]
    w = wcls(path)
    for r in records:
        w.append(r)
    w.close()
    keep, size = crash(path, _frames(path))
    r = rcls(path)
    assert list(r.replay()) == records[:keep]
    assert os.path.getsize(path) == size
    r.append(("rec", "healed"))
    r.close()
    w = wcls(path)
    assert list(w.replay()) == records[:keep] + [("rec", "healed")]
    w.close()


def test_encrypted_wal_crosses(tmp_path):
    pytest.importorskip("cryptography")
    key = bytes(range(32))
    path = str(tmp_path / "wal")
    a = fill(jdb(wal_path=path, enc_key=key))
    a.close()
    b = tdb(wal_path=path, enc_key=key)
    assert dumps_of(b, tw) == dumps_of(a, jw)
    b.close()
    with pytest.raises(ValueError, match="encrypted"):
        tdb(wal_path=path)


# -- snapshots ---------------------------------------------------------------


def test_snapshot_file_bytes_equal(tmp_path):
    jp, tp = str(tmp_path / "j.snap"), str(tmp_path / "t.snap")
    jsnap.save_snapshot(fill(jdb()), jp)
    tsnap.save_snapshot(fill(tdb()), tp)
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_snapshot_crosses_with_equal_tablets(tmp_path, direction):
    path = str(tmp_path / "s.snap")
    if direction == "ref_to_port":
        a = fill(jdb())
        jsnap.save_snapshot(a, path)
        b = tsnap.load_snapshot(path, device="cpu")
        assert dumps_of(b, tw) == dumps_of(a, jw)
        assert b.coordinator.max_assigned() == a.coordinator.max_assigned()
    else:
        a = fill(tdb())
        tsnap.save_snapshot(a, path)
        b = jsnap.load_snapshot(path, db=jdb())
        assert dumps_of(b, jw) == dumps_of(a, tw)


def test_legacy_v0_snapshot_loads_alike():
    j = jsnap.load_snapshot(FIXTURE, db=jdb())
    t = tsnap.load_snapshot(FIXTURE, device="cpu")
    assert dumps_of(t, tw) == dumps_of(j, jw)
    assert t.schema.describe_all() == j.schema.describe_all()
    # and keeps accepting writes, with the same uids
    assert t.mutate(set_nquads='_:c <legacy.name> "gamma" .')["uids"] == \
        j.mutate(set_nquads='_:c <legacy.name> "gamma" .')["uids"]
    assert dumps_of(t, tw) == dumps_of(j, jw)


def test_future_format_snapshot_refused(tmp_path):
    payload = jsnap.dump_state(fill(jdb()))
    payload["format_version"] = jver.FORMAT_VERSION + 1
    path = str(tmp_path / "future.snap")
    with open(path, "wb") as raw, \
            gzip.GzipFile(filename="", fileobj=raw, mode="wb",
                          mtime=0) as f:
        f.write(jsnap.SNAPSHOT_MAGIC)
        f.write(jw.dumps(payload))
    with pytest.raises(tver.UnsupportedFormat):
        tsnap.load_snapshot(path, device="cpu")


def test_versions_equal():
    assert (tver.FORMAT_VERSION, tver.PROTOCOL_VERSION) == \
        (jver.FORMAT_VERSION, jver.PROTOCOL_VERSION)
    assert tver.versions_payload() == jver.versions_payload()
    assert [tver.negotiate(p) for p in range(3)] == \
        [jver.negotiate(p) for p in range(3)]


# -- group-varint ------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 47, 48, 10**5])
def test_gv_streams_equal_reference_native(n, monkeypatch):
    """The port's gv_encode writes the reference's native bytes through
    its host runtime and, with the runtime switched off, through its
    scalar (under 48 uids) and numpy paths; each package decodes the
    other's stream."""
    assert jnative.available()
    rng = np.random.default_rng(n)
    steps = rng.choice(np.array([1, 200, 70_000, 5 << 32], np.uint64), n,
                       p=[0.5, 0.3, 0.15, 0.05])
    uids = np.cumsum(steps, dtype=np.uint64)
    blob = jcodec.gv_encode(uids)
    for on in (True, False):
        if not on:
            monkeypatch.setattr(tnative, "available", lambda: False)
        assert tcodec.gv_encode(uids) == blob
        assert np.array_equal(tcodec.gv_decode(blob), uids)
        assert np.array_equal(jcodec.gv_decode(tcodec.gv_encode(uids)), uids)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 9, 46])
def test_gv_short_streams_decode_as_numpy(n, monkeypatch):
    """gv_decode's scalar branch (under 48 uids, the runtime switched
    off) equals the numpy decoder on the reference's native streams,
    wide deltas included."""
    monkeypatch.setattr(tnative, "available", lambda: False)
    rng = np.random.default_rng(100 + n)
    steps = rng.choice(np.array([1, 300, 70_000, 1 << 40], np.uint64), n)
    uids = np.cumsum(steps, dtype=np.uint64)
    blob = jcodec.gv_encode(uids)
    got = tcodec.gv_decode(blob)
    assert got.dtype == np.uint64
    assert np.array_equal(got, tcodec.gv_decode_np(blob))
    assert np.array_equal(got, uids)


@pytest.mark.parametrize("n", [5, 47, 48, 200])
def test_gv_truncated_streams_raise(n, monkeypatch):
    """Both branches of gv_decode refuse a cut stream."""
    blob = jcodec.gv_encode(np.arange(1, n + 1, dtype=np.uint64) * 1000)
    for on in (True, False):
        if not on:
            monkeypatch.setattr(tnative, "available", lambda: False)
        for cut in (4, 12, len(blob) - 1):
            with pytest.raises(ValueError, match="gv decode"):
                tcodec.gv_decode(blob[:cut])


# -- tabstats and vecstore ---------------------------------------------------


def test_tabstats_equal():
    j, t = fill(jdb()), fill(tdb())
    for db in (j, t):
        db.rollup_all(0)
    for pred in sorted(j.tablets):
        assert tstats.tablet_stats(t.tablets[pred]) == \
            jstats.tablet_stats(j.tablets[pred])
        assert tstats.tablet_summary(t.tablets[pred]) == \
            jstats.tablet_summary(j.tablets[pred])


def _vector_db(make, n=4096, d=16):
    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    db = make()
    db.alter("emb: float32vector .")
    for s in range(0, n, 1024):
        db.mutate(set_json=[
            {"uid": hex(i + 1),
             "emb": "[" + ", ".join(map(repr, vecs[i].tolist())) + "]"}
            for i in range(s, min(n, s + 1024))])
    db.rollup_all(0)
    return db


def test_build_ivf_payload_equal():
    j, t = _vector_db(jdb), _vector_db(tdb)
    jix = jvec.build_ivf(j.tablets["emb"], force=True)
    tix = tvec.build_ivf(t.tablets["emb"], force=True)
    jp, tp = jvec.ivf_to_payload(jix), tvec.ivf_to_payload(tix)
    assert tp == jp
    assert tw.dumps(tp) == jw.dumps(jp)
    # the payload loads back onto the tablet's device with equal bytes
    back = tvec.ivf_from_payload(jp, "cpu")
    assert back.codes_dev.device.type == "cpu"
    assert tvec.ivf_to_payload(back) == jp
    # and ships inside dump_tablet alike
    assert tw.dumps(tsnap.dump_tablet(t.tablets["emb"])) == \
        jw.dumps(jsnap.dump_tablet(j.tablets["emb"]))
