"""The port's observed-cost store (dgraph_tpu_torch.utils.coststore)
against the reference's (dgraph_tpu.utils.coststore): the cases of
tests/test_coststore.py run through both packages with equal summaries
(apart from `ageS`, seconds since a cell's last observation on the
process's clock), and a table saved by either loads into the other with
equal summaries.

A store-backed engine (`GraphDB(store_dir=...)`) saves the table at
close and loads it at open in both packages, with equal summaries, and
a close-then-reopen in one process does not count its observations
twice."""

import json

import pytest

from dgraph_tpu.utils import coststore as jcs
from dgraph_tpu.utils import metrics as jmetrics
from dgraph_tpu.utils import tracing as jtracing
from dgraph_tpu_torch.utils import coststore as tcs
from dgraph_tpu_torch.utils import metrics as tmetrics
from dgraph_tpu_torch.utils import tracing as ttracing

PKGS = {"ref": (jcs, jtracing, jmetrics), "port": (tcs, ttracing, tmetrics)}


def summary(cs, **kw):
    return [{k: v for k, v in e.items() if k != "ageS"}
            for e in cs.summary(**kw)]


def both(fn):
    j, t = fn("ref"), fn("port")
    assert t == j
    return j


def test_constants_equal():
    assert (tcs.BUCKETS_US, tcs.EWMA_ALPHA, tcs.N_BUCKETS) == \
        (jcs.BUCKETS_US, jcs.EWMA_ALPHA, jcs.N_BUCKETS)


def _records(pkg):
    cs = PKGS[pkg][0].CostStore()
    cs.record("eq", "host", "abcd", 3, 1.5, "t1")
    cs.record("eq", "host", "abcd", 3, 3.5, "t2")
    cs.record("sort", "host", "p1", 0, 500.0)
    cs.record("eq", "host", "p2", 0, 2.0)
    st = cs.stats()
    return (summary(cs), summary(cs, stage="eq"), summary(cs, skeleton="p2"),
            st["keys"], st["observations"])


def test_record_and_summary_alike():
    full, eq, p2, keys, obs = both(_records)
    assert [e["stage"] for e in full] == ["sort", "eq", "eq"]
    assert len(eq) == 2 and len(p2) == 1 and (keys, obs) == (3, 4)


def _observer(pkg):
    cs_mod, tracing, _ = PKGS[pkg]
    cs = cs_mod.CostStore()
    tracing.add_span_observer(cs.observe_span)
    try:
        with cs_mod.bind_plan("cafe0123"):
            with tracing.span("eq", pred="name", n=100):
                pass
        with tracing.span("device.tile_load", edges=5000):
            pass
        with tracing.span("rrandom.nonstage"):
            pass
    finally:
        tracing.remove_span_observer(cs.observe_span)
    return sorted((e["stage"], e["tier"], e["skeleton"], e["size_bucket"],
                   e["count"], bool(e["max_trace"])) for e in cs.summary())


def test_observer_aggregates_stage_spans_alike():
    assert both(_observer) == [
        ("device.tile_load", "device", "", 13, 1, True),
        ("eq", "host", "cafe0123", 7, 1, True)]


def _overflow(pkg):
    cs = PKGS[pkg][0].CostStore()
    cs.MAX_KEYS = 4
    for i in range(4):
        cs.record("eq", "host", f"skel{i}", 0, 1.0)
    for i in range(10):
        cs.record("eq", "host", f"hot{i}", 0, 1.0)
    st = cs.stats()
    return summary(cs), st["keys"], st["observations"]


def test_overflow_folds_alike():
    _, keys, obs = both(_overflow)
    assert (keys, obs) == (5, 14)


def _saved(pkg, path):
    cs = PKGS[pkg][0].CostStore()
    cs.record("eq", "host", "p", 2, 4.0, "tA")
    cs.record("sort", "host", "", 0, 1.0, "tB")
    cs.record("eq", "device", "q", 9, 123.25, "tC")
    cs.save(path)
    with open(path) as f:
        doc = json.load(f)
    for ent in doc["entries"]:
        ent.pop("age_s")
    return doc


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_save_and_load_cross(tmp_path, writer, reader):
    """A table saved by one package loads into the other and saves back
    the same entries; merging into a live table gives equal summaries."""
    wpath = str(tmp_path / "w.json")
    doc = _saved(writer, wpath)
    assert doc == _saved(reader, str(tmp_path / "same.json"))
    rcs = PKGS[reader][0].CostStore()
    assert rcs.load(wpath) == 3
    back = str(tmp_path / "back.json")
    rcs.save(back)
    with open(back) as f:
        got = json.load(f)
    for ent in got["entries"]:
        ent.pop("age_s")
    assert got == doc

    def merged(pkg):
        cs = PKGS[pkg][0].CostStore()
        cs.record("eq", "host", "p", 2, 16.0, "tB")
        assert cs.load(wpath) == 3
        return summary(cs)

    both(merged)


def _corrupt(pkg, tmp_path):
    cs = PKGS[pkg][0].CostStore()
    n_missing = cs.load(str(tmp_path / "absent.json"))
    p = tmp_path / f"{pkg}.json"
    p.write_text("{not json")
    n_bad = cs.load(str(p))
    p2 = tmp_path / f"{pkg}2.json"
    p2.write_text(json.dumps({"version": 1, "entries": [
        {"stage": "eq"},
        {"stage": "ok", "tier": "host", "skeleton": "", "bucket": 0,
         "hist": [0] * (jcs.N_BUCKETS + 1), "count": 1, "sum_us": 1.0,
         "ewma_us": 1.0, "max_us": 1.0}]}))
    return n_missing, n_bad, cs.load(str(p2)), summary(cs)


def test_load_tolerates_missing_and_corrupt_alike(tmp_path):
    assert both(lambda pkg: _corrupt(pkg, tmp_path))[:3] == (0, 0, 1)


def test_save_then_load_same_path_does_not_double(tmp_path):
    cs = tcs.CostStore()
    cs.record("eq", "host", "s", 3, 2.0, "t1")
    p = str(tmp_path / "coststore.json")
    cs.save(p)
    assert cs.load(p) == 0
    cs2 = tcs.CostStore()
    assert cs2.load(p) == 1 and cs2.load(p) == 0
    assert cs2.stats()["observations"] == 1


def _prometheus(pkg):
    cs_mod, _, metrics = PKGS[pkg]
    metrics.reset()
    cs_mod.reset()
    cs_mod.record("eq", "host", "", 0, 2.0, "tx")
    text = metrics.render_prometheus()
    cs_mod.reset()
    return [ln for ln in text.splitlines()
            if "dgraph_stage_duration" in ln or "exemplar" in ln]


def test_prometheus_exposition_alike():
    lines = both(_prometheus)
    assert any('trace_id="tx"' in ln for ln in lines)


def test_global_store_is_always_on():
    tcs.reset()
    with ttracing.span("encode"):
        pass
    assert tcs.stats()["observations"] == 1
    tcs.reset()


def _restart(pkg, tmp_path):
    """A store-backed engine's observations survive a restart: saved
    at close, loaded at open (tests/test_coststore.py's two engine
    cases)."""
    import dgraph_tpu.native
    from dgraph_tpu.engine.db import GraphDB as JDB
    from dgraph_tpu_torch.engine.db import GraphDB as TDB

    cs_mod, _, _ = PKGS[pkg]
    G, kw = (JDB, {}) if pkg == "ref" else (TDB, {"device": "cpu"})
    d = tmp_path / pkg
    orig = dgraph_tpu.native.available
    dgraph_tpu.native.available = lambda: False
    try:
        cs_mod.reset()
        db = G(store_dir=str(d), prefer_device=False, **kw)
        db.alter(schema_text="name: string @index(exact) .")
        db.mutate(set_nquads='<0x1> <name> "a" .')
        db.query('{ q(func: has(name)) { name } }')
        db.close()
        seen = cs_mod.stats()["observations"]
        saved = (d / "coststore.json").exists()
        db = G(store_dir=str(d), prefer_device=False, **kw)   # no reset
        same = cs_mod.stats()["observations"]
        db.close()
        cs_mod.reset()
        db = G(store_dir=str(d), prefer_device=False, **kw)
        loaded = cs_mod.stats()["observations"]
        keys = sorted((e["stage"], e["tier"]) for e in cs_mod.summary())
        db.close()
        return seen > 0, saved, same == seen, 0 < loaded <= seen, keys
    finally:
        dgraph_tpu.native.available = orig
        cs_mod.reset()


def test_engine_persists_coststore_across_restart_alike(tmp_path):
    assert both(lambda pkg: _restart(pkg, tmp_path))[:4] == \
        (True, True, True, True)
