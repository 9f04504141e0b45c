"""The port's engine write path (dgraph_tpu_torch.engine.db.GraphDB)
against the reference's, on the CPU: the golden movie graph
(tests/golden/dataset.py, scale 1, 26,718 RDF) loaded through `mutate`
in transactions of 1,000 N-Quads into `GraphDB(plan_cache_size=0)` and
`GraphDB(plan_cache_size=0, device="cpu")`, then rolled up, then given a
second round of mixed sets and deletes (S P *, S * *, facets, @lang
values, JSON sets and deletes) and rolled up again.

At each stage every predicate's `dump_tablet` gives equal `wire.dumps`
bytes; reads at an older read_ts across the overlay are equal; `state()`
and `debug_stats()` are equal apart from the process-global cost tables,
which hold wall times; `bfs` answers alike with `prefer_device` on and
off; conflicts and aborts raise the same errors.

The query path's seams (`query`, `query_json`, upsert and conditional
mutations, the default plan cache, the adaptive planner, sharded
exports and `split_prune`) run through both engines and give equal
results (test_lifted_seams_equal_the_reference; the query path itself
is held in test_torch_query_golden and test_torch_query_paths).

`mesh` (a device mesh taking predicates onto its uid shards) also runs
through both engines (test_lifted_seams_equal_the_reference; the mesh
paths themselves are held in test_torch_sharded_engine).

The cold-storage options (`store_dir` with `tablet_budget`,
`checkpoint`, `result_cache_entries`, `prefetch_workers`) run through
both engines alike (test_cold_options_equal_the_reference; cold
storage itself is held in test_torch_cold_storage, test_torch_backup
and test_torch_ingest)."""

import numpy as np
import pytest
import torch

from dgraph_tpu import wire as jw
from dgraph_tpu.cluster.coordinator import TxnAborted as JAborted
from dgraph_tpu.engine.db import GraphDB as JDB
from dgraph_tpu.storage import snapshot as jsnap
from dgraph_tpu_torch import wire as tw
from dgraph_tpu_torch.cluster.coordinator import TxnAborted as TAborted
from dgraph_tpu_torch.engine.db import GraphDB as TDB, Mutation
from dgraph_tpu_torch.storage import snapshot as tsnap
from tests.golden import dataset

SCHEMA, LINES = dataset.generate(1)
PREDS = sorted({ln.split("> <", 1)[1].split(">", 1)[0] for ln in LINES})
BATCH = 1000
STAGES = ("loaded", "rolled", "mixed", "mixed_rolled")
BFS_PREDS = ("starring", "genre", "director.film")
REV_PREDS = ("genre", "performance.actor", "director.film")
UID_PREDS = ("genre", "starring", "performance.actor",
             "performance.character", "director.film", "country")


def film(i):
    return dataset._uid("film", i)


def perf(i):
    return dataset._uid("perf", i)


def mixed_round():
    """The second round: several commits of sets and deletes."""
    out = []
    out.append({"del_nquads": "\n".join(
        f"<{film(i):#x}> <genre> * ." for i in range(0, 60, 3))})
    out.append({"del_nquads": "\n".join(
        f"<{perf(i):#x}> * * ." for i in range(0, 40, 4))
        + f"\n<{film(7):#x}> * * ."})
    out.append({"set_nquads": "\n".join(
        [f"<{film(i):#x}> <starring> <{perf(i):#x}> (billing={i % 5}) ."
         for i in range(100, 130)]
        + [f'<{film(i):#x}> <name> "Titel {i}"@de .' for i in range(90)]
        + [f'<{film(i):#x}> <name> "Renamed Film {i}" .'
           for i in range(0, 300, 7)]
        + [f'<{film(i):#x}> <rating> "{i % 10}.5" .'
           for i in range(200, 260)]
        + [f"<{film(i):#x}> <genre> <{dataset._uid('genre', i % 24):#x}> ."
           for i in range(300, 400)]
        + ['_:new <name> "A New Film" .',
           f"_:new <director.film> <{film(3):#x}> ."])})
    out.append({"del_nquads": "\n".join(
        [f"<{film(i):#x}> <rating> * ." for i in range(400, 420)]
        + [f'<{film(i):#x}> <name> "Film {i} auf Deutsch"@de .'
           for i in range(0, 60, 3)]
        + [f'<{film(i):#x}> <aka> "Working Title {i}" .'
           for i in range(0, 100, 5)])})
    out.append({"set_json": [{"uid": hex(film(i)), "runtime": 90 + i,
                              "tagline": f"json tale {i}"}
                             for i in range(500, 540)]})
    out.append({"delete_json": [{"uid": hex(film(i)), "tagline": None}
                                for i in range(500, 510)]})
    out.append({"mutations": [
        Mutation(set_nquads=f'<{film(600):#x}> <runtime> "61" .'),
        Mutation(del_nquads=f"<{film(601):#x}> <country> * .")]})
    return out


def _mutations(kw, jmod):
    """A mixed-round mutation for package `jmod`'s GraphDB (the
    `mutations=` list carries that package's Mutation class)."""
    if "mutations" not in kw:
        return kw
    return {"mutations": [jmod.Mutation(set_nquads=m.set_nquads,
                                        del_nquads=m.del_nquads)
                          for m in kw["mutations"]]}


def _host_copies(db):
    """Bytes of the reference's `RevBucket.in_nb_host`, a host copy of
    each bitmap-adjacency bucket that the port does not keep (its
    bitgraph re-derives from the device tensors): the one term by which
    the two tile caches' host columns differ."""
    n = 0
    for tab in db.tablets.values():
        for attr in ("_device_badj", "_device_badj_t"):
            badj = getattr(tab, attr, None)
            if badj is not None:
                n += sum(b.in_nb_host.nbytes for b in badj.buckets
                         if getattr(b, "in_nb_host", None) is not None)
    return n


def _strip(stats, db):
    """A state()/debug_stats() payload without the process-global cost
    tables (their cells hold wall-clock durations and every span of the
    process, not only this engine's), with the tile cache's host column
    net of `_host_copies`. Its host peak is the most over a history
    whose terms differ by those copies, so it is held apart: at least
    the host column."""
    out = {k: v for k, v in stats.items() if k not in ("cost", "costStore")}
    dc = dict(out["deviceCache"])
    dc["hostBytes"] -= _host_copies(db)
    assert dc.pop("peakHostBytes") >= stats["deviceCache"]["hostBytes"]
    out["deviceCache"] = dc
    return out


def _reads(db, ts):
    """Per-uid reads through the MVCC overlay at `ts`."""
    out = {}
    films = [film(i) for i in range(0, 620, 3)]
    for pred in UID_PREDS:
        tab = db.tablets[pred]
        out[("dst", pred)] = [tab.get_dst_uids(u, ts).tolist()
                              for u in films + [perf(i) for i in range(60)]]
    for pred in REV_PREDS:
        tab = db.tablets[pred]
        targets = sorted(tab.reverse)[:200]
        out[("rev", pred)] = [tab.get_reverse_uids(u, ts).tolist()
                              for u in targets]
    for pred in ("name", "aka", "tagline", "rating"):
        tab = db.tablets[pred]
        toks = sorted(tab.index)[:: max(1, len(tab.index) // 60)]
        out[("index", pred)] = [(t, tab.index_uids(t, ts).tolist())
                                for t in toks]
    return out


def _columns(db, ts):
    out = {}
    for pred in ("name", "rating", "runtime", "initial_release_date",
                 "tagline"):
        vc = db.tablets[pred].value_columns(ts)
        out[pred] = None if vc is None else \
            (vc.srcs.tolist(), int(vc.tid),
             None if vc.data is None else vc.data.tolist(), vc.enc)
    return out


def _bfs(db):
    rng = np.random.default_rng(5)
    out = {}
    for pred in BFS_PREDS:
        srcs = sorted(db.tablets[pred].edges)
        for k in range(6):
            seeds = rng.choice(srcs, 1 + 3 * k, replace=False)
            for dev in (True, False):
                db.prefer_device = dev
                out[(pred, k, dev)] = [lv.tolist()
                                       for lv in db.bfs(pred, seeds, 3)]
        db.prefer_device = True
    return out


def _drive(db, wire, snap, jmod):
    dumps = {}

    def dump(stage):
        dumps[stage] = {p: wire.dumps(snap.dump_tablet(t))
                        for p, t in sorted(db.tablets.items())}

    rec = {"dumps": dumps}
    db.alter(SCHEMA)
    rec["uids"] = [db.mutate(set_nquads="\n".join(LINES[s:s + BATCH]))
                   ["uids"] for s in range(0, len(LINES), BATCH)]
    dump("loaded")
    rec["state_loaded"] = _strip(db.state(), db)
    rec["debug_loaded"] = _strip(db.debug_stats(), db)
    db.rollup_all(0)
    dump("rolled")
    rec["bfs_rolled"] = _bfs(db)
    rec["state_rolled"] = _strip(db.state(), db)
    rec["debug_rolled"] = _strip(db.debug_stats(), db)
    ts0 = db.coordinator.max_assigned()
    for kw in mixed_round():
        rec.setdefault("mixed_uids", []).append(
            db.mutate(**_mutations(kw, jmod))["uids"])
    ts1 = db.coordinator.max_assigned()
    dump("mixed")
    rec["reads_old"] = _reads(db, ts0)
    rec["reads_new"] = _reads(db, ts1)
    rec["columns_dirty"] = _columns(db, ts1)
    rec["state_mixed"] = _strip(db.state(), db)
    db.rollup_all(0)
    dump("mixed_rolled")
    rec["columns"] = _columns(db, db.coordinator.max_assigned())
    rec["bfs_final"] = _bfs(db)
    rec["state_final"] = _strip(db.state(), db)
    rec["debug_final"] = _strip(db.debug_stats(), db)
    rec["export"] = wire.dumps(db.export_tablet("genre"))
    rec["export_move"] = wire.dumps(db.export_tablet_move("starring"))
    return rec


@pytest.fixture(scope="module")
def runs():
    import dgraph_tpu.engine.db as jdbmod
    import dgraph_tpu_torch.engine.db as tdbmod
    return {
        "ref": _drive(JDB(plan_cache_size=0), jw, jsnap, jdbmod),
        "port": _drive(TDB(plan_cache_size=0, device="cpu"), tw, tsnap,
                       tdbmod),
    }


def test_dataset_is_the_golden_scale_1():
    assert len(LINES) == 26_718
    assert len(PREDS) == 13


@pytest.mark.parametrize("pred", PREDS)
@pytest.mark.parametrize("stage", STAGES)
def test_dump_tablet_bytes_equal(runs, stage, pred):
    j = runs["ref"]["dumps"][stage]
    t = runs["port"]["dumps"][stage]
    assert pred in j
    assert t[pred] == j[pred]


@pytest.mark.parametrize("stage", STAGES)
def test_same_tablets(runs, stage):
    assert sorted(runs["port"]["dumps"][stage]) == \
        sorted(runs["ref"]["dumps"][stage])


def test_assigned_uids_equal(runs):
    assert runs["port"]["uids"] == runs["ref"]["uids"]
    assert runs["port"]["mixed_uids"] == runs["ref"]["mixed_uids"]
    assert runs["port"]["mixed_uids"][2] != {}


@pytest.mark.parametrize("key", ["reads_old", "reads_new", "columns_dirty",
                                 "columns"])
def test_reads_equal(runs, key):
    assert runs["port"][key] == runs["ref"][key]


def test_reads_see_the_overlay(runs):
    """The older read_ts really reads below the mixed round."""
    assert runs["ref"]["reads_old"] != runs["ref"]["reads_new"]
    assert all(v is None for v in runs["ref"]["columns_dirty"].values())
    assert all(v is not None for v in runs["ref"]["columns"].values())


@pytest.mark.parametrize("key", ["state_loaded", "debug_loaded",
                                 "state_rolled", "debug_rolled",
                                 "state_mixed", "state_final",
                                 "debug_final"])
def test_state_and_debug_stats_equal(runs, key):
    assert runs["port"][key] == runs["ref"][key]


@pytest.mark.parametrize("key", ["bfs_rolled", "bfs_final"])
def test_bfs_equal_device_on_and_off(runs, key):
    t, j = runs["port"][key], runs["ref"][key]
    assert t == j
    for (pred, k, dev), levels in t.items():
        assert levels == t[(pred, k, not dev)]
    assert any(lv for levels in t.values() for lv in levels)


@pytest.mark.parametrize("key", ["export", "export_move"])
def test_exports_equal(runs, key):
    assert runs["port"][key] == runs["ref"][key]


# -- errors ------------------------------------------------------------------


def _err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the error is the result
        return type(e).__name__, str(e)
    return None


def _conflict_script(db):
    db.alter("name: string @index(exact) .\nfriend: [uid] .")
    db.mutate(set_nquads='<0x1> <name> "a" .')
    out = []
    t1, t2 = db.new_txn(), db.new_txn()
    db.mutate(t1, set_nquads='<0x1> <name> "b" .')
    db.mutate(t2, set_nquads='<0x1> <name> "c" .')
    out.append(db.commit(t1) > 0)
    out.append(_err(lambda: db.commit(t2)))
    out.append(_err(lambda: db.commit(t2)))
    out.append(_err(lambda: db.mutate(t1, set_nquads='<0x1> <name> "d" .')))
    t3 = db.new_txn()
    db.discard(t3)
    out.append(_err(lambda: db.commit(t3)))
    out.append(_err(lambda: db.mutate(set_nquads="<0x1> <name> <0x2> .")))
    out.append(_err(lambda: db.mutate(set_nquads="<0x1> <friend> * .")))
    out.append(_err(lambda: db.mutate(set_nquads="<0x0> <friend> <0x2> .")))
    out.append(_err(lambda: db.mutate(set_nquads="<0x1> * * .")))
    out.append(_err(lambda: db.mutate(set_nquads='<zz> <name> "x" .')))
    out.append(db.coordinator.max_assigned())
    return out


def test_conflicts_and_aborts_raise_alike():
    j = _conflict_script(JDB(plan_cache_size=0))
    t = _conflict_script(TDB(plan_cache_size=0, device="cpu"))
    assert t == j
    assert j[1][0] == JAborted.__name__ == TAborted.__name__


# -- the port's own contract -------------------------------------------------


def _db():
    db = TDB(plan_cache_size=0, device="cpu")
    db.alter("name: string .\nfriend: [uid] .")
    return db


def _cold_store_dir(G, kw, d):
    db = G(plan_cache_size=0, store_dir=str(d), tablet_budget=1, **kw)
    db.alter("name: string @index(exact) .\nfriend: [uid] .")
    db.mutate(set_nquads='<0x1> <name> "ada" .\n<0x1> <friend> <0x2> .\n'
                         '<0x2> <name> "bob" .')
    db.rollup_all(0)
    db.close()
    db = G(plan_cache_size=0, store_dir=str(d), **kw)
    out = (sorted(db.tablets.keys()), db.query(
        '{ q(func: eq(name, "ada")) { name friend { name } } }')["data"])
    db.close()
    return out, (d / "SNAPSHOT.py").exists(), (d / "WAL").read_bytes()


def _cold_result_cache(G, kw, d):
    db = G(plan_cache_size=4, result_cache_entries=4, **kw)
    db.alter("name: string @index(exact) .")
    db.mutate(set_nquads='<0x1> <name> "ada" .')
    q = '{ q(func: eq(name, "ada")) { name } }'
    outs = [db.query(q)["data"] for _ in range(3)]
    db.mutate(set_nquads='<0x2> <name> "ada" .')
    outs.append(db.query(q)["data"])
    st = db.result_cache.stats()
    return outs, st["entries"], st["capacity"], st["preds"]


def _cold_prefetch(G, kw, d):
    db = G(plan_cache_size=0, store_dir=str(d), **kw)
    db.alter("name: string @index(exact) .\nfriend: [uid] .")
    db.mutate(set_nquads='<0x1> <name> "ada" .\n<0x1> <friend> <0x2> .')
    db.rollup_all(0)
    db.close()
    db = G(plan_cache_size=0, store_dir=str(d), prefetch_workers=2, **kw)
    out = db.query('{ q(func: eq(name, "ada")) { friend { uid } } }')
    st = db.prefetcher.stats()
    db.close()
    return out["data"], st["workers"], sorted(st), db.prefetcher


def _cold_checkpoint(G, kw, d):
    db = G(plan_cache_size=0, **kw)
    with pytest.raises(RuntimeError) as e:
        db.checkpoint()
    db = G(plan_cache_size=0, store_dir=str(d), **kw)
    db.mutate(set_nquads='<0x1> <name> "ada" .')
    db.checkpoint()
    wal = (d / "WAL").read_bytes()
    db.close()
    return str(e.value), wal


COLD = {"store_dir": _cold_store_dir,
        "result_cache": _cold_result_cache,
        "prefetch": _cold_prefetch,
        "checkpoint": _cold_checkpoint}


@pytest.mark.parametrize("option", sorted(COLD))
def test_cold_options_equal_the_reference(option, tmp_path, monkeypatch):
    import dgraph_tpu.native
    monkeypatch.setattr(dgraph_tpu.native, "available", lambda: False)
    j = COLD[option](JDB, {}, tmp_path / "ref")
    t = COLD[option](TDB, {"device": "cpu"}, tmp_path / "port")
    assert t == j


def _both():
    """GraphDB as a twin: each call runs on the reference's engine and
    on the port's (`device="cpu"`), and the results must be equal."""
    from tests.test_torch_query_paths import Twin
    return Twin(JDB, TDB, "GraphDB")


def _twin_db(**kw):
    db = _both()(**kw)
    db.alter("name: string @index(exact) .\nfriend: [uid] .")
    db.mutate(set_nquads='_:a <name> "x" .\n_:b <name> "y" .\n'
                         "_:a <friend> _:b .")
    return db


def _split_prune():
    db = _twin_db()
    db.apply_record(("split_prune", "name", 2, 0))
    return (db.export_tablet("name"), sorted(db.split_partial),
            db.query("{ q(func: has(name)) { uid name } }")["data"])


def _mesh():
    """A 4-shard uid mesh on each side (the reference's virtual CPU
    devices, the port's CPU entries): the friend edge expands across
    it."""
    from dgraph_tpu.parallel import make_mesh as jmesh
    from dgraph_tpu_torch.parallel import make_mesh as tmesh
    from tests.test_torch_query_paths import Twin

    mesh = Twin(jmesh(4, axes=("uid",)),
                tmesh(devices=["cpu"] * 4, axes=("uid",)), "mesh")
    db = _twin_db(mesh=mesh, shard_min_edges=1, device_min_edges=10**9)
    db.rollup_all(0)
    return db.query("{ q(func: has(name)) { name friend { name } } }")


def _sharded_export():
    db = _twin_db()
    db.rollup_all(0)
    return [db.export_tablet_move("name", 2, shard) for shard in (0, 1)]


# the query path's seams, each now run through both engines: the call
# must give the reference's result (or raise its error)
LIFTED = {
    "plan_cache": lambda: _twin_db().state()["planCache"],
    "adaptive": lambda: _both()(plan_cache_size=0, planner="adaptive"),
    "query": lambda: _twin_db().query("{ q(func: has(name)) { name } }"),
    "query_json": lambda: _twin_db().query_json(
        "{ q(func: has(name)) { uid } }"),
    "upsert": lambda: _twin_db().mutate(
        query='{ v as var(func: eq(name, "x")) }',
        set_nquads='uid(v) <name> "z" .'),
    "cond": lambda: _twin_db().mutate(
        query='{ v as var(func: eq(name, "q")) }',
        set_nquads='_:c <name> "w" .', cond="@if(eq(len(v), 0))"),
    "cond_in_mutation": lambda: _twin_db().mutate(
        query='{ v as var(func: eq(name, "x")) }',
        mutations=[Mutation(set_nquads='_:c <name> "w" .',
                            cond="@if(eq(len(v), 0))"),
                   Mutation(set_nquads='uid(v) <name> "v" .',
                            cond="@if(eq(len(v), 1))")]),
    "mesh": _mesh,
    "split_prune": _split_prune,
    "sharded_export": _sharded_export,
}


@pytest.mark.parametrize("seam", sorted(LIFTED))
def test_lifted_seams_equal_the_reference(seam):
    if seam == "adaptive":
        # an explicit "adaptive" with no plan cache is the reference's
        # ValueError; with the default cache it runs
        with pytest.raises(ValueError, match="needs the plan cache"):
            LIFTED[seam]()
        # decisions follow the process-global cost tables, which other
        # tests fill: both start empty, and exploration (which probes
        # cold tiers on a wall-time budget) is off, so both planners
        # decide from the same evidence
        from dgraph_tpu.utils import coststore as jcost
        from dgraph_tpu_torch.utils import coststore as tcost
        jcost.reset()
        tcost.reset()
        db = _twin_db(planner="adaptive", planner_explore=False)
        assert db.planner == "adaptive"
        db.query('{ q(func: eq(name, "x")) { name } }')
        db.planner_impl.stats()
        return
    LIFTED[seam]()


def test_upsert_takes_its_timestamp_like_the_reference():
    db = _twin_db()
    before = db.coordinator.max_assigned()
    db.mutate(query="{ v as var(func: has(name)) }",
              set_nquads='uid(v) <name> "x" .')
    assert db.coordinator.max_assigned() > before
    assert db.coordinator.min_active_ts() > before


def test_planner_auto_resolves_static():
    db = TDB(plan_cache_size=0, device="cpu")
    assert db.planner == "static" and db.planner_impl is None
    assert JDB(plan_cache_size=0).planner == "static"
    assert TDB(device="cpu").planner == JDB().planner == "adaptive"
    with pytest.raises(ValueError, match="planner must be"):
        TDB(plan_cache_size=0, planner="fast", device="cpu")


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDB(plan_cache_size=0)
    db = TDB(plan_cache_size=0, device="cpu")
    assert db.device == torch.device("cpu")


def test_device_probes_read_the_engine_device():
    db = TDB(plan_cache_size=0, device="cpu")
    assert db.device_is_accelerator() is False
    assert db.device_dispatch_seconds() > 0.0


def test_tablets_carry_the_engine_device():
    db = _db()
    db.mutate(set_nquads='_:a <name> "x" .\n_:a <friend> _:b .')
    assert {t.device for t in db.tablets.values()} == {torch.device("cpu")}
