"""The port's device tiles (dgraph_tpu_torch.engine.device_cache) and
their residency budget (engine.tile_cache.DeviceCacheLRU) against the
reference's, on the CPU.

The same clean tablets give the same tiles: `device_adjacency`,
`device_radjacency`, `device_bitadjacency` (forward and transposed) and
`device_values` (plain and @lang), taken to numpy field by field, equal
the reference's. Uid arrays compare as uint64: the port holds int64
uids where the reference holds uint32, so its tiles charge about twice
the bytes to the device column (a decided difference). A dirty tablet
answers None until rollup; `expand_np` answers alike; on tiles of equal
byte size the LRU evicts in the same order.

Without a device mesh `device_sharded_adjacency` answers None, as the
reference's does; on a mesh it is held in test_torch_sharded_engine."""

import dataclasses

import numpy as np
import pytest
import torch

from dgraph_tpu.engine import device_cache as jdc
from dgraph_tpu.engine.db import GraphDB as JDB
from dgraph_tpu_torch.engine import device_cache as tdc
from dgraph_tpu_torch.engine.db import GraphDB as TDB
from tests.golden import dataset

PKGS = {"ref": (jdc, lambda **kw: JDB(plan_cache_size=0, **kw)),
        "port": (tdc, lambda **kw: TDB(plan_cache_size=0, device="cpu",
                                       **kw))}
# host-only fields of the reference's tiles that the port does not keep
REF_ONLY = {"in_nb_host"}


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        return np.asarray(x)
    return x


def same_tile(j, t, path="tile"):
    """Field-by-field equality of a reference tile `j` and a port tile
    `t`; arrays by value, uid arrays (uint32 there, int64 here) as
    uint64."""
    if dataclasses.is_dataclass(j):
        assert type(j).__name__ == type(t).__name__, path
        for f in dataclasses.fields(j):
            if f.name in REF_ONLY:
                continue
            same_tile(getattr(j, f.name), getattr(t, f.name),
                      f"{path}.{f.name}")
        return
    if isinstance(j, (list, tuple)):
        assert len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            same_tile(a, b, f"{path}[{i}]")
        return
    a, b = to_np(j), to_np(t)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        if a.dtype != b.dtype:
            assert (a.dtype, b.dtype) == (np.uint32, np.int64), \
                (path, a.dtype, b.dtype)
            assert (b >= 0).all() and (b <= 0xFFFFFFFF).all(), path
            a, b = a.astype(np.uint64), b.astype(np.uint64)
        assert np.array_equal(a, b), path
        return
    assert a == b, path


@pytest.fixture(scope="module")
def golden():
    schema, lines = dataset.generate(1)
    out = {}
    for pkg, (_, make) in PKGS.items():
        db = make(device_min_edges=1)
        db.alter(schema)
        for s in range(0, len(lines), 1000):
            db.mutate(set_nquads="\n".join(lines[s:s + 1000]))
        db.rollup_all(0)
        out[pkg] = db
    return out


UID_PREDS = ["genre", "starring", "performance.actor",
             "performance.character", "director.film", "country"]
REV_PREDS = ["genre", "performance.actor", "director.film"]
VAL_PREDS = [("rating", ""), ("runtime", ""), ("initial_release_date", ""),
             ("name", ""), ("name", "de")]


def _tiles(golden, fn_name, pred, **kw):
    out = []
    for pkg in ("ref", "port"):
        dc = PKGS[pkg][0]
        db = golden[pkg]
        tab = db.tablets[pred]
        out.append(getattr(dc, fn_name)(
            db, tab, db.coordinator.max_assigned(), **kw))
    return out


@pytest.mark.parametrize("pred", UID_PREDS)
def test_adjacency_equal(golden, pred):
    j, t = _tiles(golden, "device_adjacency", pred)
    assert j is not None
    same_tile(j, t)


@pytest.mark.parametrize("pred", REV_PREDS)
def test_radjacency_equal(golden, pred):
    j, t = _tiles(golden, "device_radjacency", pred)
    assert j is not None
    same_tile(j, t)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("pred", ["starring", "genre", "director.film"])
def test_bitadjacency_equal(golden, pred, transpose):
    j, t = _tiles(golden, "device_bitadjacency", pred, transpose=transpose)
    assert j is not None
    same_tile(j, t)
    assert t.device == torch.device("cpu")


@pytest.mark.parametrize("pred,lang", VAL_PREDS)
def test_values_equal(golden, pred, lang):
    j, t = _tiles(golden, "device_values", pred, lang=lang)
    assert j is not None
    same_tile(j, t)


def test_tiles_charge_the_bytes_the_device_holds(golden):
    """Each port tile's device charge is its tensors' bytes; the same
    adjacency charges about twice the reference's (int64 uids)."""
    j, t = _tiles(golden, "device_adjacency", "starring")
    jbytes = golden["ref"].device_cache._entries[
        (id(golden["ref"].tablets["starring"]), "_device_adj")][2]
    tbytes = golden["port"].device_cache._entries[
        (id(golden["port"].tablets["starring"]), "_device_adj")][2]
    tensors = [t.src_uids, t.degrees] + \
        [x for b in t.buckets for x in (b.src, b.neighbors)]
    assert tbytes == sum(x.nbytes for x in tensors)
    assert 1.9 * jbytes < tbytes <= 2 * jbytes


@pytest.mark.parametrize("n", [1, 8, 1024, None])
def test_expand_np_equal(golden, n):
    j, t = _tiles(golden, "device_adjacency", "starring")
    srcs = np.asarray(sorted(golden["ref"].tablets["starring"].edges),
                      np.uint64)
    src = srcs if n is None else srcs[::max(1, len(srcs) // n)][:n]
    want = jdc.expand_np(j, src)
    got = tdc.expand_np(t, src)
    assert got.dtype == np.uint64
    assert np.array_equal(got, want)
    tab = golden["port"].tablets["starring"]
    host = tab.expand_frontier(src, golden["port"].coordinator.max_assigned())
    assert np.array_equal(got, host)
    assert t._expander_cache


def test_sharded_adjacency_needs_a_mesh(golden):
    j, t = _tiles(golden, "device_sharded_adjacency", "starring")
    assert j is None and t is None


def _dirty(pkg):
    dc, make = PKGS[pkg]
    db = make(device_min_edges=1)
    db.alter("p: [uid] @reverse .\nv: int .")
    db.mutate(set_nquads="\n".join(
        f"<{s:#x}> <p> <{0x100 + (s * 7 + d) % 97:#x}> .\n"
        f'<{s:#x}> <v> "{s * 3 % 11}" .'
        for s in range(1, 60) for d in range(5)))
    db.rollup_all(0)
    pin = db.new_txn()  # an open txn pins the rollup watermark
    db.mutate(set_nquads="<0x1> <p> <0x999> .\n<0x2> <v> \"7\" .")
    ts = db.coordinator.max_assigned()
    tab_p, tab_v = db.tablets["p"], db.tablets["v"]
    dirty = (dc.device_adjacency(db, tab_p, ts),
             dc.device_radjacency(db, tab_p, ts),
             dc.device_bitadjacency(db, tab_p, ts),
             dc.device_values(db, tab_v, ts))
    overlay = dc.device_adjacency(db, tab_p, ts, allow_dirty=True)
    db.discard(pin)
    db.rollup_all(0)
    ts = db.coordinator.max_assigned()
    clean = (dc.device_adjacency(db, tab_p, ts),
             dc.device_radjacency(db, tab_p, ts),
             dc.device_bitadjacency(db, tab_p, ts),
             dc.device_values(db, tab_v, ts))
    host = [tab_p.get_dst_uids(s, ts).tolist() for s in (1, 2, 3)]
    return dirty, overlay, clean, host


def test_dirty_tablet_answers_none_until_rollup():
    jd, jo, jc, jh = _dirty("ref")
    td, to, tc, th = _dirty("port")
    assert all(x is None for x in jd) and all(x is None for x in td)
    same_tile(jo, to)
    for a, b in zip(jc, tc):
        assert a is not None
        same_tile(a, b)
    assert th == jh and 0x999 in th[0]
    got = tdc.expand_np(tc[0], np.asarray([1], np.uint64)).tolist()
    assert got == th[0]


def _lru_db(make, **kw):
    """Six uid predicates whose adjacency tiles have equal byte size."""
    db = make(device_min_edges=1, **kw)
    db.alter("\n".join(f"p{i}: [uid] ." for i in range(6)))
    db.mutate(set_nquads="\n".join(
        f"<{s:#x}> <p{i}> <{0x1000 + (s * 7 + d) % 997:#x}> ."
        for i in range(6) for s in range(1, 41) for d in range(40)))
    db.rollup_all(0)
    return db


def _lru(pkg, budget_tiles):
    """With a budget of `budget_tiles` tiles: builds p0..p5, touches p2,
    builds p0 again, and returns which tablets hold a tile after each
    step, the evictions and the resident tiles."""
    dc, make = PKGS[pkg]
    probe = _lru_db(make)
    ts = probe.coordinator.max_assigned()
    sizes = set()
    for i in range(6):
        dc.device_adjacency(probe, probe.tablets[f"p{i}"], ts)
        sizes.add(probe.device_cache._entries[
            (id(probe.tablets[f"p{i}"]), "_device_adj")][2])
    assert len(sizes) == 1
    db = _lru_db(make, device_hbm_budget=int(sizes.pop()
                                             * (budget_tiles + 0.5)))
    ts = db.coordinator.max_assigned()

    def held():
        return [i for i in range(6)
                if db.tablets[f"p{i}"]._device_adj is not None]

    steps = []
    for i in range(6):
        dc.device_adjacency(db, db.tablets[f"p{i}"], ts)
        steps.append(held())
    dc.device_adjacency(db, db.tablets["p2"], ts)  # touch: p2 is MRU
    dc.device_adjacency(db, db.tablets["p0"], ts)
    steps.append(held())
    st = db.state()["deviceCache"]
    return steps, st["evictions"], st["tiles"]


@pytest.mark.parametrize("budget_tiles", [1, 2, 3, 6])
def test_lru_evicts_in_the_same_order(budget_tiles):
    j, t = _lru("ref", budget_tiles), _lru("port", budget_tiles)
    assert t == j
    if budget_tiles == 3:
        assert 2 in t[0][-1] and 0 in t[0][-1]


def test_drop_all_and_dead_tablets_free_the_budget():
    import gc
    db = PKGS["port"][1](device_min_edges=1)
    db.alter("p: [uid] .\nq: [uid] .")
    db.mutate(set_nquads="\n".join(
        f"<{s:#x}> <{p}> <{0x100 + s:#x}> ." for s in range(1, 30)
        for p in "pq"))
    db.rollup_all(0)
    ts = db.coordinator.max_assigned()
    for p in "pq":
        assert tdc.device_adjacency(db, db.tablets[p], ts) is not None
    assert db.device_cache.bytes > 0
    db.tablets.pop("q")
    gc.collect()
    assert db.device_cache.stats()["tiles"] == 1
    db.alter(drop_all=True)
    assert db.device_cache.bytes == 0 and not db.device_cache._entries
