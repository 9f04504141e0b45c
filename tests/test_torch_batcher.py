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
# which words the expired member's DeadlineExceeded carries depends on
# whether its thread joined the first thread's 10 ms window ("deadline
# expired while queued in batch") or, under load, led a batch of its own
# and expired in the engine ("deadline exceeded at parse ..."): the case's
# own assertions hold either way, on both passes
TIMED = ("TestDeadlines::"
         "test_deadline_expires_queued_returns_408_without_poisoning",)


def test_the_reference_file_holds_its_cases():
    assert len(CASES) == 17 and set(TIMED) < set(CASES)


@pytest.mark.parametrize("case", CASES)
def test_batcher_through_both(case, tmp_path):
    run_twins("test_batcher", [case], tmp_path,
              compare=None if case in TIMED else "multiset")


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


def _expired_member_error(pkg: str, window_us: int, gap_s: float) -> str:
    """What a member with an 80 ms budget gets in `pkg`'s batcher while
    a writer holds the read lock for 250 ms, submitted `gap_s` after an
    unbounded member."""
    import importlib
    import re
    import time
    from contextlib import contextmanager

    db = importlib.import_module(f"{pkg}.engine.db").GraphDB(
        prefer_device=False, **({"device": "cpu"} if pkg != "dgraph_tpu"
                                else {}))
    batcher = importlib.import_module(f"{pkg}.engine.batcher")
    reqctx = importlib.import_module(f"{pkg}.utils.reqctx")
    db.alter(schema_text="name: string @index(exact) .")
    db.mutate(set_nquads='_:a <name> "alice" .', commit_now=True)
    stall = threading.Lock()

    @contextmanager
    def stalled_lock():
        with stall:
            yield
    mb = batcher.MicroBatcher(db, window_us=window_us, max_batch=8,
                              read_lock=stalled_lock)
    q = '{ q(func: eq(name, "alice")) { uid name } }'
    out = [None, None]

    def submit(i, ctx):
        try:
            out[i] = mb.query_json(q, ctx=ctx)
        except reqctx.RequestAborted as e:
            out[i] = e
    stall.acquire()
    first = threading.Thread(target=submit, args=(0, None))
    first.start()
    time.sleep(gap_s)
    second = threading.Thread(target=submit, args=(
        1, reqctx.RequestContext.with_timeout(0.08)))
    second.start()
    time.sleep(0.25)
    stall.release()
    first.join()
    second.join()
    assert isinstance(out[0], str) and \
        type(out[1]).__name__ == "DeadlineExceeded"
    return re.sub(r"trace [0-9a-f]+", "trace <id>", str(out[1]))


def test_expired_member_words_follow_the_window():
    """The reference case TestDeadlines::test_deadline_expires_queued_...
    compares no records: its expired member's words depend on whether it
    joined the first member's window (a 200 ms window) or led its own (a
    10 ms window, submitted 50 ms later). Either way both packages say
    the same words."""
    for window_us, gap_s, said in (
            (200_000, 0.0, "deadline expired while queued in batch"),
            (10_000, 0.05, "deadline exceeded at parse (trace <id>)")):
        for pkg in ("dgraph_tpu", "dgraph_tpu_torch"):
            assert _expired_member_error(pkg, window_us, gap_s) == said
