"""The port's query modules against the reference's, module by module,
on the CPU.

The reference's own tests of each module run with their `dgraph_tpu`
names twinned (tests/test_torch_query_paths.py explains the twin): the
same inputs go through both packages and every result must be equal.

- `query/colvar` (tests/test_colvar.py);
- `query/retrigram.compile_trigram_query` (tests/test_retrigram.py's
  patterns, its necessity fuzz included);
- `query/plan`: `skeleton`, `PlanCache` keys, hits and evictions,
  `jit_stage` and `shape_bucket` (tests/test_plan_cache.py);
- `query/planner`: `AdaptivePlanner` decisions from the same coststore
  contents, written through both packages' coststores, and
  `token_quantile` (tests/test_planner.py);
- `query/explain.build_explain`'s plan tree (tests/test_explain.py,
  with wall times left out, over the 75-query golden workload too; its
  HTTP and gRPC cases wait for the serving slice, ROADMAP Queue 1 item
  10).

Then `cluster/shard` and `cluster/errors`, which no reference test
drives alone, on seeded inputs here. `shard_view` rebuilds the view's
token index; the native batch tokenizer inserts the index's tokens in
another order than the Python path (equal contents, other
`dump_tablet` bytes), so the shard test runs with the host runtime off
in both packages (`native.available` patched to False) and, in its
`_native_on` twin, on in both.
"""

import numpy as np
import pytest

from dgraph_tpu import wire as jw
from dgraph_tpu.cluster import errors as jerr, shard as jshard
from dgraph_tpu.engine.db import GraphDB as JDB
from dgraph_tpu.storage import snapshot as jsnap
from dgraph_tpu_torch import wire as tw
from dgraph_tpu_torch.cluster import errors as terr, shard as tshard
from dgraph_tpu_torch.engine.db import GraphDB as TDB
from dgraph_tpu_torch.storage import snapshot as tsnap
from tests.test_torch_query_paths import (
    case_id, reference_tests, run_reference_case,
)

# the serving surfaces (server/http, server/grpc_api) are not ported
SERVING = ("test_http_explain_param", "test_http_explain_directive",
           "test_http_bad_explain_is_400", "test_http_debug_stats_endpoint",
           "test_grpc_explain_directive")

CASES = [(mod, name, ps)
         for mod, skip in (("test_colvar", ()), ("test_retrigram", ()),
                           ("test_plan_cache", ()), ("test_planner", ()),
                           ("test_explain", SERVING))
         for name, ps in reference_tests(mod, skip)]


@pytest.mark.parametrize("ref_name,test_name,params", CASES,
                         ids=[case_id(*c) for c in CASES])
def test_reference_case_through_both(ref_name, test_name, params, request,
                                     monkeypatch):
    run_reference_case(ref_name, test_name, request, monkeypatch, params)


# -- cluster/shard and cluster/errors ----------------------------------------

RNG = np.random.default_rng(20261017)
UIDS = RNG.integers(1, 1 << 40, 4096, dtype=np.uint64)


@pytest.mark.parametrize("nshards", [1, 2, 3, 8])
def test_shard_hash_and_masks_equal(nshards):
    for u in UIDS[:256].tolist():
        assert tshard.mix64(u) == jshard.mix64(u)
        assert tshard.shard_of(u, nshards) == jshard.shard_of(u, nshards)
    for s in range(nshards):
        np.testing.assert_array_equal(tshard.shard_mask(UIDS, nshards, s),
                                      jshard.shard_mask(UIDS, nshards, s))
    entry = {"owners": [3, 1, 3, 2][:nshards] or [1]}
    assert tshard.owners_of(entry) == jshard.owners_of(entry)
    for u in UIDS[:64].tolist():
        assert tshard.owner_for_uid(entry, u) == \
            jshard.owner_for_uid(entry, u)


def _sharded_engine(G, **kw):
    db = G(**kw)
    db.alter("name: string @index(term) @lang .\nfriend: [uid] @reverse .\n"
             "type T { name friend }")
    db.mutate(set_nquads="\n".join(
        [f'<{u:#x}> <dgraph.type> "T" .' for u in range(1, 20)]
        + [f'<{u:#x}> <name> "n{u % 7} x" .' for u in range(1, 200)]
        + [f'<{u:#x}> <name> "d{u}"@de .' for u in range(1, 200, 5)]
        + [f"<{u:#x}> <friend> <{(u * 7) % 199 + 1:#x}> (w={u % 3}) ."
           for u in range(1, 200)]))
    db.rollup_all(0)
    # an unfolded overlay the view filters per op
    db.mutate(set_nquads='<0x5> <name> "late" .\n<0x6> <friend> <0x9> .')
    return db


@pytest.mark.parametrize("pred", ["name", "friend"])
@pytest.mark.parametrize("invert", [False, True])
def test_shard_view_equal(pred, invert, monkeypatch):
    import dgraph_tpu.native
    import dgraph_tpu_torch.native

    monkeypatch.setattr(dgraph_tpu.native, "available", lambda: False)
    monkeypatch.setattr(dgraph_tpu_torch.native, "available", lambda: False)
    shard_view_equal(pred, invert)


@pytest.mark.parametrize("pred", ["name", "friend"])
@pytest.mark.parametrize("invert", [False, True])
def test_shard_view_equal_native_on(pred, invert):
    shard_view_equal(pred, invert)


def shard_view_equal(pred, invert):
    j = _sharded_engine(JDB, plan_cache_size=0)
    t = _sharded_engine(TDB, plan_cache_size=0, device="cpu")
    for shard in range(3):
        jv = jshard.shard_view(j.tablets[pred], 3, shard, invert=invert)
        tv = tshard.shard_view(t.tablets[pred], 3, shard, invert=invert)
        assert tv.device == t.device
        assert tw.dumps(tsnap.dump_tablet(tv)) == \
            jw.dumps(jsnap.dump_tablet(jv))
        assert [(ts, [(o.src, int(o.dst)) for o in ops])
                for ts, ops in tv.deltas] == \
            [(ts, [(o.src, int(o.dst)) for o in ops])
             for ts, ops in jv.deltas]


@pytest.mark.parametrize("cls,args", [
    ("TabletMisrouted", ("name",)), ("TabletMisrouted", ("name", 3)),
    ("TabletMisrouted", ("name", 3, "custom")),
    ("StaleRead", (7, 5)), ("StaleRead", (7, 5, "m")),
    ("WriteFenced", ()), ("WriteFenced", ("standby",)),
])
def test_cluster_errors_equal(cls, args):
    je, te = getattr(jerr, cls)(*args), getattr(terr, cls)(*args)
    assert str(te) == str(je)
    assert vars(te) == vars(je)
    assert isinstance(te, RuntimeError)
    assert terr.WIRE_ERRORS == jerr.WIRE_ERRORS


def test_split_partial_query_is_misrouted_alike():
    """An expand() reaching a split-partial predicate fails typed in
    both (the executor's ownership check at expansion time)."""
    outs = []
    for G, kw, err in ((JDB, {}, jerr), (TDB, {"device": "cpu"}, terr)):
        db = _sharded_engine(G, **kw)
        db.apply_record(("split_prune", "name", 2, 0))
        with pytest.raises(err.TabletMisrouted) as e:
            db.query("{ q(func: uid(0x1)) { expand(_all_) } }")
        outs.append((str(e.value), sorted(db.split_partial)))
    assert outs[0] == outs[1]
