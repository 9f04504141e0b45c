"""The port's GraphDB on a device mesh against the reference's, on the
CPU: uid-range tablet sharding inside the engine, the sharded
similar_to tiers and the fused page on a mesh.

tests/test_sharded_engine.py's cases run through both engines — the
reference's on a mesh of its 8 virtual CPU devices, the port's on a
mesh of 8 CPU entries (`make_mesh(devices=[cpu] * 8, axes=("uid",))`) —
and through each package's engine without a mesh: the query data must
be equal across all four, and the port's counters must move as the
reference's do (`query_sharded_expand_total{dir}`,
`query_similar_sharded_total`, EXPLAIN's `sharded` and
`sharded_quantized` vector tiers). The sharded tile is charged to the
tile budget: the port holds int64 uids where the reference holds
uint32, so it charges exactly twice the reference's bytes (the decided
difference of every port tile). Then the 75 golden queries at scale 1
on a mesh engine with every predicate sharded.
"""

import numpy as np
import pytest
import torch

from dgraph_tpu.engine.db import GraphDB as JDB
from dgraph_tpu.engine import device_cache as jdc
from dgraph_tpu.parallel import make_mesh as jmake_mesh
from dgraph_tpu.utils import metrics as jmetrics
from dgraph_tpu_torch.engine import device_cache as tdc
from dgraph_tpu_torch.engine.db import GraphDB as TDB
from dgraph_tpu_torch.parallel import make_mesh as tmake_mesh
from dgraph_tpu_torch.utils import metrics as tmetrics
from tests.golden import runner
from tests.test_golden import _json_close
from tests.test_knn import _clustered
from tests.test_sharded_engine import _edges
from tests.test_torch_query_paths import golden_text, port_golden_db

CPU = torch.device("cpu")
SCHEMA = "follows: [uid] @reverse .\nname: string @index(exact) ."


def tmesh(n=8):
    return tmake_mesh(devices=[CPU] * n, axes=("uid",))


def jmesh():
    return jmake_mesh(axes=("uid",))


def _mkdb(pkg, mesh=None, **kw):
    """tests/test_sharded_engine.py's engine: every tier past the
    single-device threshold, every predicate past the shard threshold."""
    kw.setdefault("device_min_edges", 10**9)
    kw.setdefault("shard_min_edges", 1)
    db = JDB(mesh=mesh, **kw) if pkg == "ref" else \
        TDB(mesh=mesh, device="cpu", **kw)
    db.alter(SCHEMA)
    db.mutate(set_nquads=_edges())
    db.rollup_all()
    return db


def _host(pkg):
    db = JDB(prefer_device=False) if pkg == "ref" else \
        TDB(prefer_device=False, device="cpu")
    db.alter(SCHEMA)
    db.mutate(set_nquads=_edges())
    return db


@pytest.fixture(scope="module")
def engines():
    return {"ref": _mkdb("ref", jmesh()), "port": _mkdb("port", tmesh()),
            "ref_host": _host("ref"), "port_host": _host("port")}


def test_mesh_has_multiple_uid_shards():
    assert tmesh().shape["uid"] == jmesh().shape["uid"] == 8


QUERIES = {
    "expand": '{ q(func: uid(0x1, 0x2, 0x3)) { follows { name } } }',
    "recurse": '{ q(func: uid(0x1)) @recurse(depth: 3) { name follows } }',
    "reverse": '{ q(func: uid(0x1001, 0x1002)) { ~follows { name } } }',
    "two_hop": '{ q(func: uid(0x5, 0x9)) { follows { ~follows { uid } } } }',
}
DIRS = {"expand": ("fwd",), "recurse": (), "reverse": ("rev",),
        "two_hop": ("fwd", "rev")}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_sharded_query_matches_reference_and_host(engines, name):
    q = QUERIES[name]
    want = engines["ref_host"].query(q)["data"]
    assert engines["port_host"].query(q)["data"] == want
    counters = {}
    for pkg, metrics in (("ref", jmetrics), ("port", tmetrics)):
        before = metrics.snapshot()["counters"]
        assert engines[pkg].query(q)["data"] == want, pkg
        after = metrics.snapshot()["counters"]
        counters[pkg] = {
            d: after.get(f'query_sharded_expand_total{{dir="{d}"}}', 0)
            - before.get(f'query_sharded_expand_total{{dir="{d}"}}', 0)
            for d in ("fwd", "rev")}
    assert counters["port"] == counters["ref"]
    for d in DIRS[name]:
        assert counters["port"][d] > 0, d
    # each direction's sharded tile exists once a query walked it: the
    # forward one is built by a forward expand, the reverse one by a
    # reverse expand (a case alone builds only its own)
    tab = engines["port"].tablets["follows"]
    if "fwd" in DIRS[name]:
        assert tab._device_sadj is not None
    if "rev" in DIRS[name]:
        assert tab._device_sadj_r is not None


def _tile_bytes(adj) -> int:
    return sum(t.numel() * t.element_size() for b in adj.buckets
               for t in b.src + b.neighbors)


def test_sharded_tile_obeys_hbm_budget():
    got = {}
    for pkg, dc, mesh in (("ref", jdc, jmesh()), ("port", tdc, tmesh())):
        db = _mkdb(pkg, mesh)
        ts = db.coordinator.max_assigned()
        tab = db.tablets["follows"]
        sadj = dc.device_sharded_adjacency(db, tab, ts)
        assert sadj is not None
        assert dc.device_sharded_adjacency(db, tab, ts) is sadj
        key = (id(tab), "_device_sadj")
        got[pkg] = db.device_cache._entries[key][2]
        if pkg == "port":
            assert got[pkg] == _tile_bytes(sadj)
            assert all(t.device == CPU for b in sadj.buckets
                       for t in b.src + b.neighbors)
            assert len(sadj.buckets[0].src) == 8
    assert got["port"] == 2 * got["ref"] > 0


def test_eviction_clears_the_sharded_tiles():
    """Under a budget below one tile, admitting the reverse tile evicts
    the forward one and clears its tablet attribute; the next query
    rebuilds it (and admits its host exports), evicting as the
    reference's does."""
    got = {}
    for pkg, dc, mesh, metrics in (("ref", jdc, jmesh(), jmetrics),
                                   ("port", tdc, tmesh(), tmetrics)):
        db = _mkdb(pkg, mesh, device_hbm_budget=1)
        ts = db.coordinator.max_assigned()
        tab = db.tablets["follows"]
        fwd = dc.device_sharded_adjacency(db, tab, ts)
        assert tab._device_sadj is fwd
        dc.device_sharded_adjacency(db, tab, ts, reverse=True)
        assert tab._device_sadj is None and tab._device_sadj_ts == -1, pkg
        assert tab._device_sadj_r is not None
        assert db.device_cache.evictions == 1
        before = metrics.snapshot()["counters"].get(
            'query_sharded_expand_total{dir="fwd"}', 0)
        data = db.query(QUERIES["expand"])["data"]
        after = metrics.snapshot()["counters"].get(
            'query_sharded_expand_total{dir="fwd"}', 0)
        stats = db.device_cache.stats()
        got[pkg] = (data, after - before, stats["evictions"],
                    stats["tiles"], stats["bytes"])
    assert got["port"] == got["ref"]
    assert got["port"][1] == 1 and got["port"][2] > 1


def test_below_threshold_stays_single_device():
    for pkg, dc, mesh in (("ref", jdc, jmesh()), ("port", tdc, tmesh())):
        db = _mkdb(pkg, mesh, device_min_edges=1, shard_min_edges=10**9)
        db.query('{ q(func: uid(0x1)) { follows { uid } } }')
        tab = db.tablets["follows"]
        assert getattr(tab, "_device_sadj", None) is None, pkg
        # the verdict is memoized per base_ts
        assert tab._device_sadj_small_ts == tab.base_ts
        assert dc.device_sharded_adjacency(
            db, tab, db.coordinator.max_assigned()) is None


def test_one_uid_shard_takes_the_single_device_tiers():
    """A mesh whose uid axis is 1 (make_mesh on one card) never shards."""
    db = _mkdb("port", tmake_mesh(devices=[CPU]), device_min_edges=1)
    before = tmetrics.counters_snapshot()
    db.query(QUERIES["expand"])
    delta = tmetrics.counters_delta(before)
    assert not any(k.startswith("query_sharded_expand_total") for k in delta)
    assert delta.get('query_device_expand_total{dir="fwd"}', 0) > 0


# -- similar_to on a mesh ---------------------------------------------------


def _vec_db(pkg, mesh=None, vecs=None, **kw):
    rdf = "\n".join(
        f'<0x{i + 1:x}> <embedding> "{list(map(float, vecs[i]))}"'
        '^^<xs:float32vector> .' for i in range(len(vecs)))
    kw.setdefault("prefer_device", False)
    kw.setdefault("vec_index_min_rows", 100)
    kw.setdefault("planner", "static")
    db = JDB(mesh=mesh, **kw) if pkg == "ref" else \
        TDB(mesh=mesh, device="cpu", **kw)
    db.alter("embedding: float32vector @index(vector) .")
    db.mutate(set_nquads=rdf, commit_now=True)
    db.rollup_all()
    return db


VEC_QUERIES = [
    '{ q(func: similar_to(embedding, 4, "[0.5, -0.25, 1.0, 0.0]")) '
    '{ uid score: val(similar_to_score) } }',
    '{ q(func: similar_to(embedding, 10, "[1.0, 0.5, -0.5, 0.25]")) '
    '{ uid score: val(similar_to_score) } }',
]


@pytest.mark.parametrize("quantized", [True, False])
def test_similar_to_sharded_tiers(quantized):
    """tests/test_knn.py's sharded tier cases (`_quant_db`'s 500 x 4
    clustered corpus, index trained past vec_index_min_rows=100) on both
    tiers: the mesh engines answer as the unsharded ones, EXPLAIN names
    the reference's tier, and query_similar_sharded_total moves once a
    request. The sharded exact tier scores in float32 where the host
    tier of the unsharded engine scores in float64: its ids are equal,
    its scores within 1e-6."""
    vecs = _clustered(500, 4, centers=16, seed=40)
    tier = "sharded_quantized" if quantized else "sharded"
    for q in VEC_QUERIES:
        want = _vec_db("ref", vecs=vecs, vec_quantized=quantized) \
            .query(q)["data"]
        for pkg, mesh, metrics in (("ref", jmesh(), jmetrics),
                                   ("port", tmesh(), tmetrics)):
            plain = _vec_db(pkg, vecs=vecs, vec_quantized=quantized)
            db = _vec_db(pkg, mesh, vecs=vecs, vec_quantized=quantized,
                         shard_min_edges=8)
            if quantized:
                assert db.tablets["embedding"].vector_ivf() is not None
            before = metrics.snapshot()["counters"].get(
                "query_similar_sharded_total", 0)
            res = db.query(q, explain="analyze")
            after = metrics.snapshot()["counters"].get(
                "query_similar_sharded_total", 0)
            vd = res["extensions"]["explain"]["tiers"]["vector"]
            assert vd and vd[0]["tier"] == tier, (pkg, vd)
            assert after - before == 1, pkg
            if quantized:
                # both re-rank the same rows in float64
                assert res["data"] == plain.query(q)["data"], pkg
            ids = [r["uid"] for r in res["data"]["q"]]
            assert ids == [r["uid"] for r in want["q"]], pkg
            for a, b in zip(res["data"]["q"], want["q"]):
                assert abs(a["score"] - b["score"]) <= 1e-6, pkg


def test_similar_to_sharded_filter_context_stays_exact():
    vecs = _clustered(300, 4, centers=16, seed=41)
    db = _vec_db("port", tmesh(), vecs=vecs, shard_min_edges=8)
    db.alter("name: string @index(exact) .")
    db.mutate(set_nquads='<0x5> <name> "five" .', commit_now=True)
    res = db.query(
        '{ q(func: eq(name, "five")) @filter(similar_to(embedding, 2,'
        ' "[1.0, 0.0, 0.0, 0.0]")) { uid } }', explain="analyze")
    vd = res["extensions"]["explain"]["tiers"]["vector"]
    assert vd and vd[0]["tier"] == "sharded"


# -- the golden queries on a mesh engine ------------------------------------


_MESH_GOLDEN: dict = {}


def mesh_golden_db():
    """The golden graph at scale 1 in a port engine on a 4-entry uid
    mesh with every predicate sharded and every device tier forced."""
    if "db" not in _MESH_GOLDEN:
        from tests.golden.dataset import generate

        schema, quads = generate()
        db = TDB(device_min_edges=1, device="cpu", mesh=tmesh(4),
                 shard_min_edges=1)
        db.alter(schema_text=schema)
        db.mutate(set_nquads="\n".join(quads))
        _MESH_GOLDEN["db"] = db
    return _MESH_GOLDEN["db"]


@pytest.mark.parametrize("name", runner.query_names())
def test_golden_query_on_a_mesh(name):
    q = golden_text(name)
    got = mesh_golden_db().query(q)["data"]
    assert _json_close(got, runner.load_expected(name)), name
    assert got == port_golden_db().query(q)["data"], name


def test_golden_workload_shards_both_directions():
    before = tmetrics.counters_snapshot()
    db = mesh_golden_db()
    for name in runner.query_names():
        db.query(golden_text(name))
    delta = tmetrics.counters_delta(before)
    for counter in ('query_sharded_expand_total{dir="fwd"}',
                    'query_sharded_expand_total{dir="rev"}',
                    "query_fused_dispatch_total"):
        assert delta.get(counter, 0) > 0, counter
    assert np.all([getattr(t, "_device_sadj", None) is None
                   or len(t._device_sadj.buckets[0].src) == 4
                   for t in db.tablets.values()])
