"""The port's change streams (dgraph_tpu_torch.cdc) against the
reference's (dgraph_tpu.cdc): the cases of tests/test_cdc.py that need no
server run through both packages, and the change-log records, offsets and
floors must be equal, after the same commits and after WAL replay.

Not yet run by the port: the HTTP /subscribe long-poll and the cluster
wire op (ROADMAP Queue 1 items 10 and 11, the serving surfaces and the
cluster), and bulk loads (item 9)."""

import json
import threading
import time

import pytest

from dgraph_tpu.cdc import changelog as jcl
from dgraph_tpu.engine.db import GraphDB as JDB
from dgraph_tpu.models import types as jtypes
from dgraph_tpu.storage import snapshot as jsnap
from dgraph_tpu.storage import tablet as jtab
from dgraph_tpu.utils import failpoint as jfp
from dgraph_tpu_torch.cdc import changelog as tcl
from dgraph_tpu_torch.engine.db import GraphDB as TDB
from dgraph_tpu_torch.models import types as ttypes
from dgraph_tpu_torch.storage import snapshot as tsnap
from dgraph_tpu_torch.storage import tablet as ttab
from dgraph_tpu_torch.utils import failpoint as tfp

PKGS = {
    "ref": (jcl, jtypes, jtab, jfp,
            lambda **kw: JDB(plan_cache_size=0, prefer_device=False, **kw),
            jsnap),
    "port": (tcl, ttypes, ttab, tfp,
             lambda **kw: TDB(plan_cache_size=0, prefer_device=False,
                              device="cpu", **kw), tsnap),
}


def _set(pkg, src, text):
    _, types, tab, *_ = PKGS[pkg]
    return tab.EdgeOp("set", src, posting=tab.Posting(
        types.Val(types.TypeID.STRING, text)))


def both(fn):
    """fn(pkg) through both packages; equal results, returned once."""
    j, t = fn("ref"), fn("port")
    assert t == j
    return j


# --------------------------------------------------------- offset core


def _offsets(pkg):
    cl = PKGS[pkg][0]
    plane = cl.CdcPlane()
    plane.append(7, {"name": [_set(pkg, 1, "a"), _set(pkg, 2, "b")]})
    plane.append(9, {"name": [_set(pkg, 3, "c")]})
    return (plane.read("name", after=0),
            plane.read("name", after=cl.offset_for_ts(7)),
            plane.read("name", after=plane.read("name", after=0)
                       ["nextOffset"]))


def test_offsets_and_heartbeat_equal():
    r, r7, head = both(_offsets)
    offs = [e["offset"] for e in r["changes"]]
    assert offs == sorted(offs) and len(set(offs)) == 3
    assert [e["commitTs"] for e in r7["changes"]] == [9]
    assert head["heartbeat"] and not head["changes"]


def _eviction(pkg):
    cl = PKGS[pkg][0]
    plane = cl.CdcPlane(cap=4)
    for ts in range(2, 12, 2):
        plane.append(ts, {"name": [_set(pkg, ts, f"v{ts}")]})
    out = [plane.read("name", after=cl.offset_for_ts(2))]
    with pytest.raises(cl.OffsetTruncated) as ei:
        plane.read("name", after=0)
    out.append((ei.value.floor, ei.value.resync_ts))
    out.append(plane.read("name", after=cl.offset_for_ts(
        ei.value.resync_ts)))
    return out


def test_bounded_eviction_truncates_alike():
    r, (floor, _), again = both(_eviction)
    assert floor == r["floor"]
    assert [e["value"] for e in again["changes"]] == \
        ["v4", "v6", "v8", "v10"]


def _pages(pkg):
    plane = PKGS[pkg][0].CdcPlane()
    plane.append(5, {"name": [_set(pkg, i, f"v{i}") for i in range(10)]})
    out, off = [], 0
    while True:
        r = plane.read("name", after=off, limit=3)
        if not r["changes"]:
            return out
        out.append(r)
        off = r["nextOffset"]


def test_limit_pages_alike():
    pages = both(_pages)
    assert [e["value"] for p in pages for e in p["changes"]] == \
        [f"v{i}" for i in range(10)]


def _lag(pkg):
    plane = PKGS[pkg][0].CdcPlane()
    plane.append(2, {"name": [_set(pkg, 1, "a"), _set(pkg, 2, "b")]})
    first = plane.read("name", after=0, limit=1, sub_id="s1")
    out = [plane.stats()]
    plane.read("name", after=first["nextOffset"], sub_id="s1")
    return out + [plane.stats()]


def test_subscriber_lag_alike():
    st = both(_lag)
    assert st[0]["subscribers"]["s1"]["lag"] == 1
    assert st[1]["subscribers"]["s1"]["lag"] == 0


def test_long_poll_wakes_on_append():
    plane = tcl.CdcPlane()
    got = []
    t = threading.Thread(
        target=lambda: got.append(plane.read("name", after=0, wait_s=5.0)))
    t.start()
    time.sleep(0.1)
    plane.append(4, {"name": [_set("port", 1, "woke")]})
    t.join(5)
    assert not t.is_alive()
    assert got and got[0]["changes"][0]["value"] == "woke"


@pytest.mark.failpoint
def test_failpoint_seams():
    plane = tcl.CdcPlane()
    tfp.arm("cdc.append", "error(boom)")
    try:
        with pytest.raises(tfp.FailpointError):
            plane.append(2, {"name": [_set("port", 1, "x")]})
    finally:
        tfp.disarm("cdc.append")
    tfp.arm("cdc.deliver", "error(down)")
    try:
        with pytest.raises(tfp.FailpointError):
            plane.read("name", after=0)
    finally:
        tfp.disarm("cdc.deliver")


# ------------------------------------------------------- engine taps


def _db(pkg, **kw):
    db = PKGS[pkg][4](**kw)
    db.alter("name: string .\nfollows: [uid] .")
    return db


def _taps(pkg):
    db = _db(pkg)
    db.alter("score: int .\nembedding: float32vector .")
    db.mutate(set_nquads="\n".join([
        '_:a <name> "alice" .',
        '_:a <score> "41"^^<xs:int> .',
        '_:a <embedding> "[0.5, 1.0]"^^<xs:float32vector> .',
        '_:a <follows> _:b .']), commit_now=True)
    db.mutate(set_nquads='<0x1> <name> "new" .', commit_now=True)
    out = {p: db.cdc.read(p, after=0)
           for p in ("name", "score", "embedding", "follows")}
    json.dumps(out)
    return out, db.cdc.stats()


def test_engine_commit_taps_alike():
    out, _ = both(_taps)
    assert out["embedding"]["changes"][0]["value"] == [0.5, 1.0]
    assert [(e["op"], e.get("value")) for e in out["name"]["changes"]] == \
        [("set", "alice"), ("del", "alice"), ("set", "new")]


def _replay(pkg, tmp_path):
    wal = str(tmp_path / f"{pkg}.wal")
    db = _db(pkg, wal_path=wal)
    db.mutate(set_nquads='_:a <name> "durable" .\n_:a <follows> _:b .',
              commit_now=True)
    db.mutate(del_nquads="<0x1> <follows> * .", commit_now=True)
    before = {p: db.cdc.read(p, after=0) for p in ("name", "follows")}
    db.close()
    db2 = PKGS[pkg][4](wal_path=wal)
    after = {p: db2.cdc.read(p, after=0) for p in ("name", "follows")}
    db2.close()
    assert json.dumps(after) == json.dumps(before)
    return after


def test_wal_replay_rebuilds_change_log_alike(tmp_path):
    both(lambda pkg: _replay(pkg, tmp_path))


def test_replay_of_the_reference_wal_gives_its_offsets(tmp_path):
    wal = str(tmp_path / "ref.wal")
    db = _db("ref", wal_path=wal)
    db.mutate(set_nquads='_:a <name> "x" .\n_:b <name> "y" .')
    want = db.cdc.read("name", after=0)
    db.close()
    got = PKGS["port"][4](wal_path=wal).cdc.read("name", after=0)
    assert json.dumps(got) == json.dumps(want)


def _drops(pkg):
    db = _db(pkg)
    db.mutate(set_nquads='_:a <name> "x" .', commit_now=True)
    db.alter(drop_attr="name")
    out = [db.cdc.read("name", after=0)]
    db.mutate(set_nquads="_:a <follows> _:b .", commit_now=True)
    db.alter(drop_all=True)
    return out + [db.cdc.stats()]


def test_drop_attr_and_drop_all_clear_logs_alike():
    r, st = both(_drops)
    assert r["heartbeat"] and st["preds"] == {}


def _floor(pkg, tmp_path):
    cl, *_, snap = PKGS[pkg]
    db = _db(pkg)
    db.mutate(set_nquads='_:a <name> "pre" .', commit_now=True)
    path = str(tmp_path / f"{pkg}.snap")
    snap.save_snapshot(db, path)
    db2 = snap.load_snapshot(path, db=PKGS[pkg][4]())
    with pytest.raises(cl.OffsetTruncated) as ei:
        db2.cdc.read("name", after=0)
    db2.mutate(set_nquads='_:c <name> "post" .', commit_now=True)
    return (ei.value.floor, ei.value.resync_ts,
            db2.cdc.read("name", after=cl.offset_for_ts(
                ei.value.resync_ts)))


def test_snapshot_restore_sets_floor_alike(tmp_path):
    _, _, r = both(lambda pkg: _floor(pkg, tmp_path))
    assert [e["value"] for e in r["changes"]] == ["post"]
