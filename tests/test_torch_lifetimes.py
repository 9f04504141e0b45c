"""The port's native store handles (`dgraph_tpu_torch/native`: NativeKV,
NativeWal) against a close that races their users, on the CPU.

A close must wait for the call in flight and free the handle once, and
every later call must raise `native.ClosedError` instead of passing a
NULL or freed pointer to C. Each case holds a user inside a store call
(a `threading.Event` in a wrapper), closes from another thread, then
releases it, and checks three things: the close returned only after the
held call ended, the process lives, and a call after the close raises.
The holders are a prefetch decode under `GraphDB.close`, a NativeKV and
a NativeWal call under the handle's own close, a scan dropped half-way
and a scan left open, and a raft `DiskStorage` under a node stop.

Each body runs in a child process with `faulthandler` on, so that a
regression, which segfaults, fails its own case with the child's stack
instead of killing the test worker.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOLD_S = 0.5  # how long a close must stay blocked behind a held call


def run_child(body: str, tmp_path, *args: str) -> dict:
    """Run `body` in a fresh interpreter (the port on the CPU, the host
    runtime on), `args` in its ARGS; it prints one JSON object as its
    last line."""
    script = tmp_path / "child.py"
    script.write_text(PRELUDE + textwrap.dedent(body))
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path), *args], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=240)
    assert proc.returncode == 0, (
        f"child exited {proc.returncode}\n--- stdout\n{proc.stdout[-4000:]}"
        f"\n--- stderr\n{proc.stderr[-8000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


PRELUDE = '''\
import faulthandler
import gc
import json
import sys
import threading
import time

faulthandler.enable()
WHERE, ARGS = sys.argv[1], sys.argv[2:]
HOLD_S = %r

from dgraph_tpu_torch import native


def raises_closed(fn, *args):
    try:
        fn(*args)
    except native.ClosedError:
        return True
    return False


class Held:
    """`fn` wrapped so that its first call (or each call that `when`
    picks) signals `entered` and waits for `release` before going on;
    `ended` is set when the held call returns."""

    def __init__(self, fn, when=lambda *a: True):
        self.fn, self.when = fn, when
        self.entered = threading.Event()
        self.release = threading.Event()
        self.ended = threading.Event()
        self.taken = False

    def __call__(self, *args):
        if self.taken or not self.when(*args):
            return self.fn(*args)
        self.taken = True
        self.entered.set()
        assert self.release.wait(60)
        try:
            return self.fn(*args)
        finally:
            self.ended.set()


class HeldLib:
    """A bound library whose entry `name` is `held`."""

    def __init__(self, lib, name, held):
        self._lib, self._name, self._held = lib, name, held

    def __getattr__(self, name):
        return self._held if name == self._name else getattr(self._lib,
                                                              name)


def close_behind(held, close):
    """Close from another thread while `held` is in its call; returns
    (close still blocked after HOLD_S, close returned after the held
    call ended)."""
    assert held.entered.wait(60), "the held call never started"
    out = {}

    def closer():
        close()
        out["after_end"] = held.ended.is_set()
    t = threading.Thread(target=closer)
    t.start()
    t.join(HOLD_S)
    blocked = t.is_alive()
    held.release.set()
    t.join(60)
    assert not t.is_alive(), "close never returned"
    return blocked, out.get("after_end")

''' % HOLD_S


def test_graphdb_close_drains_a_prefetch_decode(tmp_path):
    """A prefetch decode held inside the store's `get`: `GraphDB.close`
    (from another thread) returns only after the decode ended, the
    process lives, a get on the closed store raises and a lazy load
    through the engine's old TabletMap finds the predicate absent."""
    got = run_child('''
        from dgraph_tpu_torch.engine.db import GraphDB

        store = WHERE + "/store"
        db = GraphDB(store_dir=store, device="cpu")
        db.alter(schema_text="score: int @index(int) .\\nlink: [uid] .")
        db.mutate(set_nquads="\\n".join(
            f'<0x{i:x}> <score> "{i % 97}" .\\n'
            f'<0x{i:x}> <link> <0x{i % 300 + 1:x}> .'
            for i in range(1, 301)))
        db.rollup_all()
        db.close()

        db = GraphDB(store_dir=store, device="cpu", prefetch_workers=1)
        kv = db.tablet_store.kv
        assert isinstance(kv, native.NativeKV)
        tablets = db.tablets
        held = Held(kv.get, when=lambda key: key == b"tab:score")
        kv.get = held
        assert db.prefetcher.schedule(db, ["score"]) == 1
        blocked, after_end = close_behind(held, db.close)
        print(json.dumps({
            "blocked": blocked, "after_end": after_end,
            "get_raises": raises_closed(native.NativeKV.get, kv, b"x"),
            "lazy_load": tablets.get("link"),
            "resident": sorted(db.tablets)}))
    ''', tmp_path)
    assert got == {"blocked": True, "after_end": True, "get_raises": True,
                   "lazy_load": None, "resident": []}


def test_a_decode_on_a_closed_store_loads_nothing(tmp_path):
    """A decode that meets a store closed behind the engine's back ends
    as "nothing loaded" and counts nothing."""
    got = run_child('''
        from dgraph_tpu_torch.engine.db import GraphDB

        db = GraphDB(store_dir=WHERE + "/store", device="cpu",
                     prefetch_workers=1)
        db.alter(schema_text="score: int .")
        db.mutate(set_nquads='<0x1> <score> "1" .')
        db.rollup_all()
        db.tablets.offload("score")
        pf = db.prefetcher
        db.tablet_store.close()
        print(json.dumps({"decode": list(pf._decode("score", db.schema)),
                          "stats": pf.stats()}))
        pf.close()
    ''', tmp_path)
    assert got["decode"] == [None, 0]
    assert {k: got["stats"][k] for k in ("hits", "bytes", "misses")} == \
        {"hits": 0, "bytes": 0, "misses": 0}


KV_CALLS = ("put", "delete", "get", "__len__", "scan", "flush", "snapshot",
            "set_memtable")
WAL_CALLS = ("append", "flush", "replay", "truncate")


@pytest.mark.parametrize("held_entry", ["dgt_kv_get", "dgt_kv_put",
                                        "dgt_kv_snapshot"])
def test_native_kv_close_waits_for_a_call_in_flight(held_entry, tmp_path):
    """A NativeKV call held inside its C entry: close waits for it, the
    call completes on the open store, and afterwards every method
    raises ClosedError."""
    got = run_child('''
        HELD = ARGS[0]
        kv = native.NativeKV(WHERE + "/kv")
        for i in range(64):
            kv.put(b"k%03d" % i, b"v%d" % i)
        held = Held(getattr(kv._lib, HELD))
        kv._lib = HeldLib(kv._lib, HELD, held)
        call = {"dgt_kv_get": lambda: kv.get(b"k007"),
                "dgt_kv_put": lambda: kv.put(b"new", b"x"),
                "dgt_kv_snapshot": kv.snapshot}[HELD]
        res = {}
        user = threading.Thread(target=lambda: res.update(got=call()))
        user.start()
        blocked, after_end = close_behind(held, kv.close)
        user.join(60)
        late = {
            "put": raises_closed(kv.put, b"a", b"b"),
            "delete": raises_closed(kv.delete, b"a"),
            "get": raises_closed(kv.get, b"a"),
            "__len__": raises_closed(len, kv),
            "scan": raises_closed(list, kv.scan(b"k")),
            "flush": raises_closed(kv.flush),
            "snapshot": raises_closed(kv.snapshot),
            "set_memtable": raises_closed(kv.set_memtable, 1 << 20)}
        kv.close()  # a second close frees nothing
        print(json.dumps({"blocked": blocked, "after_end": after_end,
                          "got": repr(res.get("got")), "late": late}))
    ''', tmp_path, held_entry)
    want = {"dgt_kv_get": "b'v7'", "dgt_kv_put": "None",
            "dgt_kv_snapshot": "None"}[held_entry]
    assert got == {"blocked": True, "after_end": True, "got": want,
                   "late": dict.fromkeys(KV_CALLS, True)}


def test_native_wal_close_waits_for_an_append_in_flight(tmp_path):
    """A NativeWal append held inside its C entry: close waits for it,
    the record lands, and afterwards every method raises."""
    got = run_child('''
        path = WHERE + "/wal"
        w = native.NativeWal(path)
        w.append(b"first")
        held = Held(w._lib.dgt_wal_append)
        w._lib = HeldLib(w._lib, "dgt_wal_append", held)
        user = threading.Thread(target=w.append, args=(b"second",))
        user.start()
        blocked, after_end = close_behind(held, w.close)
        user.join(60)
        late = {"append": raises_closed(w.append, b"x"),
                "flush": raises_closed(w.flush),
                "replay": raises_closed(w.replay),
                "truncate": raises_closed(w.truncate)}
        again = native.NativeWal(path)
        records = again.replay()
        again.close()
        print(json.dumps({"blocked": blocked, "after_end": after_end,
                          "late": late,
                          "records": [r.decode() for r in records]}))
    ''', tmp_path)
    assert got == {"blocked": True, "after_end": True,
                   "late": dict.fromkeys(WAL_CALLS, True),
                   "records": ["first", "second"]}


def test_native_kv_scans_against_close(tmp_path):
    """A scan dropped half-way frees its iterator and does not hold up
    a close; a scan still open when the store closes raises ClosedError
    at its next step instead of stepping an iterator the close freed."""
    got = run_child('''
        kv = native.NativeKV(WHERE + "/kv")
        for i in range(64):
            kv.put(b"k%03d" % i, b"v%d" % i)
        dropped = kv.scan(b"k")
        first = next(dropped)
        del dropped
        gc.collect()
        after_drop = len(getattr(kv, "_iters", ()))
        live = kv.scan(b"k")
        steps = [next(live) for _ in range(3)]
        t = threading.Thread(target=kv.close)
        t.start()
        t.join(30)
        closed_promptly = not t.is_alive()
        print(json.dumps({
            "first": first[0].decode(), "after_drop": after_drop,
            "steps": [k.decode() for k, _ in steps],
            "closed_promptly": closed_promptly,
            "next_raises": raises_closed(next, live),
            "iters": len(getattr(kv, "_iters", ()))}))
    ''', tmp_path)
    assert got == {"first": "k000", "after_drop": 0,
                   "steps": ["k000", "k001", "k002"],
                   "closed_promptly": True, "next_raises": True, "iters": 0}


def test_disk_storage_closes_after_a_node_stop(tmp_path):
    """A one-voter raft node over a DiskStorage, a propose held inside
    the store's put: the node's stop waits out that raft step; the
    storage then closes; a later propose never reaches the store, and a
    storage call after its close raises."""
    got = run_child('''
        import socket

        from dgraph_tpu_torch.cluster.raft import DiskStorage, Entry
        from dgraph_tpu_torch.cluster.service import RaftServer


        class Node(RaftServer):
            def sm_apply(self, origin, payload):
                return payload

            def sm_snapshot(self):
                return {}

            def sm_restore(self, snap):
                pass

            def handle_request(self, req):
                return {"ok": True}


        def free_port():
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
            return port

        storage = DiskStorage(WHERE + "/raft")
        assert isinstance(storage._kv, native.NativeKV)
        srv = Node(1, {1: ("127.0.0.1", free_port())},
                   ("127.0.0.1", free_port()), storage=storage,
                   tick_s=0.01, election_ticks=3)
        deadline = time.monotonic() + 30
        while not srv.is_leader():
            assert time.monotonic() < deadline, "no leader"
            time.sleep(0.01)
        applied = [srv.propose_and_wait(("w", i))[0] for i in range(20)]
        held = Held(storage._kv.put,
                    when=lambda key, val: key.startswith(b"e/"))
        storage._kv.put = held
        proposer = threading.Thread(
            target=lambda: srv.propose_and_wait(("held", 0), timeout=60))
        proposer.start()

        def stop():
            srv.close()
            storage.close()
        blocked, after_end = close_behind(held, stop)
        proposer.join(60)
        late = srv.propose_and_wait(("late", 0), timeout=1)
        time.sleep(0.1)  # a tick that raced close would land here
        print(json.dumps({
            "applied": all(applied), "blocked": blocked,
            "after_end": after_end, "late": list(late),
            "append_raises": raises_closed(
                storage.append, [Entry(1, 10 ** 6, None)]),
            "hardstate_raises": raises_closed(
                storage.save_hardstate, 9, None)}))
    ''', tmp_path)
    assert got == {"applied": True, "blocked": True, "after_end": True,
                   "late": [False, None], "append_raises": True,
                   "hardstate_raises": True}
