"""The cluster's state across the two packages, on the CPU: what a
deployment carries over instead of weights.

- Raft logs: a `DiskStorage` directory (hardstate, entries, snapshot)
  written by either package holds the same files and opens in the
  other, and a group restarted from the other package's directories
  replays the same log. Both packages write with the host runtime off
  (`native.available` False: `storage/kvfallback.PyKV`) and, in the
  `_native_on` test, on (`native.NativeKV`, the default). The records'
  wire bytes are held in test_torch_wire.
- Snapshots: the same writes give the same `save_snapshot` bytes and the
  same raft snapshot (`dump_state`) bytes in both packages, and a file
  either package wrote bulk-boots the other's cluster `AlphaServer`
  (`snapshot=`), which then answers alike.
"""

from __future__ import annotations

import time
from pathlib import Path

from dgraph_tpu import wire as jwire
from dgraph_tpu.bench.spawn import free_ports
from dgraph_tpu.cluster import harness as jharness
from dgraph_tpu.cluster import raft as jraft
from dgraph_tpu.cluster import service as jservice
from dgraph_tpu.engine.db import GraphDB as JDB
from dgraph_tpu.storage import snapshot as jsnap
from dgraph_tpu_torch import wire as twire
from dgraph_tpu_torch.cluster import harness as tharness
from dgraph_tpu_torch.cluster import raft as traft
from dgraph_tpu_torch.cluster import service as tservice
from dgraph_tpu_torch.engine.db import GraphDB as TDB
from dgraph_tpu_torch.storage import snapshot as tsnap
from tests.test_torch_cold_storage import switch_native

PKGS = {"ref": (jraft, jharness, jservice, JDB, jsnap, jwire),
        "port": (traft, tharness, tservice, TDB, tsnap, twire)}
SCHEMA = "name: string @index(exact) .\nfriend: [uid] @reverse ."
RDF = "\n".join([f'<{i:#x}> <name> "n{i}" .' for i in range(1, 41)]
                + [f"<{i:#x}> <friend> <{i % 40 + 1:#x}> ."
                   for i in range(1, 41)])
QUERY = ('{ q(func: eq(name, "n7")) { name friend { name ~friend '
         '{ name } } } }')


def _files(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _write_log(raft, d: Path):
    st = raft.DiskStorage(str(d))
    st.save_hardstate(3, 2)
    st.append([raft.Entry(1, i, ("commit", i, [], {})) for i in range(1, 9)])
    st.append([raft.Entry(2, 6, ("alter", SCHEMA))])  # truncates 6..8
    st.save_snapshot(4, 1, b"state")
    st.save_members({"members": {1: ("127.0.0.1", 1)}, "removed": [],
                     "learners": []})
    st.close()


def _read_log(raft, d: Path):
    st = raft.DiskStorage(str(d))
    try:
        return (st.term, st.voted_for, st.snap_index, st.snap_term,
                st.snap_data, [(e.term, e.index, e.data) for e in st.entries],
                st.load_members())
    finally:
        st.close()


def _disk_storage_files_equal_and_cross_open(tmp_path):
    for side in PKGS:
        _write_log(PKGS[side][0], tmp_path / side)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    want = _read_log(jraft, tmp_path / "ref")
    assert want[:4] == (3, 2, 4, 1) and [e[1] for e in want[5]] == [5, 6]
    assert _read_log(traft, tmp_path / "ref") == want
    assert _read_log(jraft, tmp_path / "port") == want


def _group_restarts_from_the_other_packages_log(writer, reader, tmp_path):
    """Three nodes of `writer` commit through DiskStorage; three nodes of
    `reader` restarted on those directories elect a leader, replay the
    same log and commit on top of it."""
    def group(side):
        raft, harness = PKGS[side][:2]
        return harness.SimCluster(3, seed=5, storage_factory=lambda i:
                                  raft.DiskStorage(str(tmp_path / f"n{i}")))

    c = group(writer)
    c.wait_leader()
    for i in range(6):
        assert c.propose(("commit", i, [], {}))
    c.pump(10)
    before = {i: list(c.applied[i]) for i in c.ids}
    for node in c.nodes.values():
        node.storage.close()
    c2 = group(reader)
    c2.wait_leader()
    assert c2.propose(("commit", 6, [], {}))
    c2.pump(10)
    for i in c2.ids:
        assert c2.applied[i][-len(before[i]) - 1:] == \
            before[i] + [("commit", 6, [], {})]
    for node in c2.nodes.values():
        node.storage.close()


def _engine(side):
    db = PKGS[side][3](**({"device": "cpu"} if side == "port" else {}),
                       prefer_device=False)
    db.alter(schema_text=SCHEMA)
    db.mutate(set_nquads=RDF, commit_now=True)
    return db


def _snapshot_and_raft_snapshot_bytes_equal(tmp_path):
    blobs = {}
    for side, (_, _, _, _, snap, wire) in PKGS.items():
        db = _engine(side)
        snap.save_snapshot(db, str(tmp_path / f"{side}.snap"))
        blobs[side] = ((tmp_path / f"{side}.snap").read_bytes(),
                       wire.dumps(snap.dump_state(db)))
    assert blobs["port"] == blobs["ref"]


def _boot(side, path: str):
    """A one-node cluster AlphaServer of `side` bulk-booted from `path`;
    its answer to QUERY once it leads."""
    service = PKGS[side][2]
    rp, cp = free_ports(2)
    kw = {"db_kw": {"device": "cpu"}} if side == "port" else {}
    srv = service.AlphaServer(1, {1: ("127.0.0.1", rp)}, ("127.0.0.1", cp),
                              snapshot=path, tick_s=0.02, election_ticks=5,
                              **kw)
    try:
        end = time.monotonic() + 30
        while not srv.is_leader():
            assert time.monotonic() < end, "no leader"
            time.sleep(0.02)
        return srv.db.query(QUERY)["data"]
    finally:
        srv.close()


def _snapshot_boots_the_other_packages_alpha(writer, reader, tmp_path):
    path = str(tmp_path / "p.snap")
    PKGS[writer][4].save_snapshot(_engine(writer), path)
    got = _boot(reader, path)
    assert got == _engine(reader).query(QUERY)["data"]
    assert got["q"][0]["friend"][0]["name"] == "n8"


def test_cluster_state_across_packages(tmp_path, monkeypatch):
    """Each check above, both ways where it has two (one test item: see
    `torch_twins.run_each`), the host runtime off in both packages."""
    switch_native(monkeypatch, False)
    cluster_state_across_packages(tmp_path)


def test_cluster_state_across_packages_native_on(tmp_path):
    """The same with the runtime on in both (NativeKV raft logs)."""
    cluster_state_across_packages(tmp_path)


def cluster_state_across_packages(tmp_path):
    def fresh(name):
        d = tmp_path / name
        d.mkdir()
        return d
    _disk_storage_files_equal_and_cross_open(fresh("disk"))
    _snapshot_and_raft_snapshot_bytes_equal(fresh("snap"))
    for writer, reader in (("ref", "port"), ("port", "ref")):
        _group_restarts_from_the_other_packages_log(
            writer, reader, fresh(f"log-{writer}"))
        _snapshot_boots_the_other_packages_alpha(
            writer, reader, fresh(f"boot-{writer}"))
