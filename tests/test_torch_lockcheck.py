"""The port's lock-order witness (dgraph_tpu_torch.utils.lockcheck)
against the reference's, on the CPU.

Every case of the reference's test_lockcheck runs through both packages
(`tests/torch_twins.run_twins`), each pass with its own package's
witness: the planted inversions fire with both stacks, the RWLock's
writer-preference paths stay clean, a project lock built while armed is
wrapped. The overhead case keeps its budget assertion on both passes
but compares no records: its batcher bodies are equal, yet how many
acquisitions a pass makes and what they cost are timing.

Then the port's own rules: its witness ranks only locks built in the
port's files (the reference's root, `.../dgraph_tpu`, is a string prefix
of the port's, so the reference's witness also wraps locks built in
port files; the port's does not wrap the reference's), it hooks the
port's RWLock, and a planted inversion inside a twin of a case the
reference marks `lockcheck` fails the port's pass.
"""

from __future__ import annotations

import pytest

from dgraph_tpu.engine import batcher as jbatcher
from dgraph_tpu.utils import rwlock as jrwlock
from dgraph_tpu_torch.engine import batcher as tbatcher
from dgraph_tpu_torch.engine import db as tdb
from dgraph_tpu_torch.utils import lockcheck, rwlock
from tests.torch_twins import reference_cases, run_twins

CASES = reference_cases("test_lockcheck")
# the budget holds on both passes; acquisitions and their cost are timing
TIMED = ("TestOverhead::test_batcher_workload_overhead_under_budget",)


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    lockcheck.disable()


def test_the_reference_file_holds_its_cases():
    assert len(CASES) == 9 and set(TIMED) < set(CASES)


@pytest.mark.parametrize("case", CASES)
def test_lockcheck_through_both(case, tmp_path):
    run_twins("test_lockcheck", [case], tmp_path,
              compare=None if case in TIMED else "multiset")


def test_the_budget_holds_with_the_port_s_engine_warm(tmp_path):
    """The overhead case after the port's query path has served its
    query in this process, as it has in a worker that ran the engine's
    twins first: a warm query takes a few tenths of a millisecond and
    about six acquisitions, so the witness's own per-acquire cost, not
    the workload's first-call costs, decides the budget."""
    db = tdb.GraphDB(device="cpu")
    db.alter(schema_text="name: string @index(exact) .")
    db.mutate(set_nquads='_:a <name> "alice" .', commit_now=True)
    mb = tbatcher.MicroBatcher(db, window_us=0)
    for _ in range(30):
        mb.query_json('{ q(func: eq(name, "alice")) { uid name } }')
    run_twins("test_lockcheck", list(TIMED), tmp_path, compare=None)


def test_the_root_is_the_port_s_package():
    assert lockcheck._PROJECT_ROOT == \
        str(__import__("pathlib").Path(tbatcher.__file__).parent.parent)
    assert lockcheck._PROJECT_ROOT.endswith("dgraph_tpu_torch")


def test_a_lock_built_in_a_port_module_is_witnessed():
    lockcheck.enable()
    mb = tbatcher.MicroBatcher(db=None, window_us=0)
    rw = rwlock.RWLock()
    assert isinstance(mb._lock, lockcheck._WitnessLock)
    assert mb._lock._name.startswith("batcher.py:")
    assert rw._lc_name.startswith("rw@")
    rw.acquire_write()
    with mb._lock:
        pass
    rw.release_write()
    assert lockcheck.stats()["edges"] == 1
    assert lockcheck.disable() == []


def test_a_lock_built_in_the_reference_is_not_witnessed():
    lockcheck.enable()
    mb = jbatcher.MicroBatcher(db=None, window_us=0)
    rw = jrwlock.RWLock()
    assert not isinstance(mb._lock, lockcheck._WitnessLock)
    assert not hasattr(rw, "_lc_name")
    rw.acquire_write()
    with mb._lock:
        pass
    rw.release_write()
    assert lockcheck.stats()["acquires"] == 0
    assert lockcheck.disable() == []


def test_disable_restores_the_lock_factory_and_rwlock():
    import threading

    lock, init = threading.Lock, rwlock.RWLock.__init__
    lockcheck.enable()
    assert threading.Lock is not lock and rwlock.RWLock.__init__ is not init
    lockcheck.disable()
    assert threading.Lock is lock and rwlock.RWLock.__init__ is init


PLANTED = "TestCoalescing::test_window_zero_passthrough"


def _plant_inversion(mp, ref_mod):
    """In the port's pass, every batcher query takes two port-witnessed
    locks in both orders."""
    if ref_mod.MicroBatcher is not tbatcher.MicroBatcher:
        return
    query_json = tbatcher.MicroBatcher.query_json

    def inverted(self, *a, **kw):
        a_lock = lockcheck.wrap_lock(name="planted-A")
        b_lock = lockcheck.wrap_lock(name="planted-B")
        for first, second in ((a_lock, b_lock), (b_lock, a_lock)):
            with first:
                with second:
                    pass
        return query_json(self, *a, **kw)
    mp.setattr(tbatcher.MicroBatcher, "query_json", inverted)


def test_a_planted_inversion_fails_the_port_s_pass(tmp_path):
    """test_batcher carries the lockcheck marker: its twin's port pass
    runs under the port's witness, which records the inversion and fails
    the pass after the reference's pass ran clean."""
    with pytest.raises(pytest.fail.Exception) as err:
        run_twins("test_batcher", [PLANTED], tmp_path,
                  setup=_plant_inversion)
    msg = str(err.value)
    assert msg.startswith("dgraph_tpu_torch: violation(s) witnessed")
    assert "[dgraph_tpu_torch.utils.lockcheck] lock-order inversion" in msg
    assert "planted-A" in msg and "planted-B" in msg
    assert not lockcheck.enabled()
