"""The port's micro-batcher (dgraph_tpu_torch.engine.batcher) against
the reference's, on the CPU.

Every case of the reference's test_batcher runs through both packages
(`tests/torch_twins.run_twins`): coalescing and single flight, the
demultiplexed bodies, per-request deadlines, error scoping and the
serving layer's wiring. The bodies each `MicroBatcher.query_json` and
each served request returned must be equal between the passes, masked
as `torch_twins.MASKED` names. The reference's cases carry the
lockcheck and racecheck markers, which arm the reference's runtime
witnesses (`utils/lockcheck`, `utils/racecheck`, Queue 1 item 12);
the port has none yet, so its pass runs without them.
"""

from __future__ import annotations

import json
import threading

import pytest

from dgraph_tpu_torch.engine.batcher import MicroBatcher
from dgraph_tpu_torch.engine.db import GraphDB
from dgraph_tpu_torch.utils import metrics
from tests.torch_twins import reference_cases, run_twins

CASES = reference_cases("test_batcher")


def test_the_reference_file_holds_its_cases():
    assert len(CASES) == 17


@pytest.mark.parametrize("case", CASES)
def test_batcher_through_both(case, tmp_path):
    run_twins("test_batcher", [case], tmp_path)


def test_identical_requests_execute_once_distinct_run_in_turn():
    """Identical concurrent requests execute once; distinct bindings
    of one plan run one after another on the leader, each executed."""
    db = GraphDB(device="cpu")
    db.alter(schema_text="name: string @index(exact) .")
    db.mutate(set_nquads="".join(f'_:n{i} <name> "n{i}" .\n'
                                 for i in range(4)), commit_now=True)
    runs = []
    inner = db.query_json

    def counted(*a, **kw):
        runs.append(a[0])
        return inner(*a, **kw)
    db.query_json = counted
    mb = MicroBatcher(db, window_us=300_000, max_batch=4)

    def fan(queries):
        out = [None] * len(queries)

        def go(i, q):
            out[i] = mb.query_json(q)
        ts = [threading.Thread(target=go, args=(i, q))
              for i, q in enumerate(queries)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        return out

    same = '{ q(func: eq(name, "n0")) { name } }'
    d0 = metrics.counters_snapshot().get("batch_dispatches", 0)
    outs = fan([same] * 4)
    assert len(runs) == 1 and len(set(outs)) == 1
    runs.clear()
    distinct = [f'{{ q(func: eq(name, "n{i}")) {{ name }} }}'
                for i in range(4)]
    outs = fan(distinct)
    assert sorted(runs) == sorted(distinct)
    assert sorted(json.loads(o)["data"]["q"][0]["name"] for o in outs) \
        == ["n0", "n1", "n2", "n3"]
    assert metrics.counters_snapshot().get("batch_dispatches", 0) - d0 == 2
