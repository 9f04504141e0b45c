"""The port's data-race witness (dgraph_tpu_torch.utils.racecheck)
against the reference's, on the CPU.

Every case of the reference's test_racecheck runs through both packages
(`tests/torch_twins.run_twins`), each pass with its own package's
witness: the planted races fire with both stacks, the clean patterns
stay clean, the hooks come off at disarm. The file registers its fixture
classes with the reference's witness when it is imported; the port's
pass registers them with the port's (`_register_fixtures`). The
sampling and stats cases keep their assertions on both passes but
compare no records: how many reads the sampler's racy tick lets through
is timing.

Then the port's own rules: `TARGETS` name the port's classes, the
locksets come from the port's lockcheck, and a planted race inside a
twin of a case the reference marks `racecheck` fails the port's pass.
"""

from __future__ import annotations

import importlib
import threading

import pytest

from dgraph_tpu_torch.engine import batcher as tbatcher
from dgraph_tpu_torch.utils import lockcheck, racecheck
from tests.torch_twins import reference_cases, run_twins

CASES = reference_cases("test_racecheck")
# the samplers' counts follow a racy tick: assertions hold, records vary
TIMED = ("TestLifecycle::test_stats_count_probes_and_samples",
         "TestLifecycle::test_sampling_thins_reads_but_not_writes")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    if racecheck.enabled():
        racecheck.disable()
    racecheck.reset()


def _register_fixtures(mp, ref_mod):
    """The reference file's fixture classes, registered with this pass's
    own witness for the pass (the port's `_extra` is restored after)."""
    rc = ref_mod.racecheck
    have = {cls for cls, _ in rc._extra}
    extra = list(rc._extra)
    for cls, ignore in ((ref_mod._Shared, ()),
                        (ref_mod._IgnoredAttr, ("x",))):
        if cls not in have:
            extra.append((cls, ignore))
    mp.setattr(rc, "_extra", extra)


def test_the_reference_file_holds_its_cases():
    assert len(CASES) == 15 and set(TIMED) < set(CASES)


@pytest.mark.parametrize("case", CASES)
def test_racecheck_through_both(case, tmp_path):
    run_twins("test_racecheck", [case], tmp_path, setup=_register_fixtures,
              compare=None if case in TIMED else "multiset")


def test_targets_resolve_to_the_port_s_classes():
    got = racecheck._resolve_targets()
    names = [f"{cls.__module__}.{cls.__qualname__}" for cls, _ in
             got[:len(racecheck.TARGETS)]]
    assert names == [
        "dgraph_tpu_torch.engine.prefetch.PrefetchPool",
        "dgraph_tpu_torch.engine.result_cache.ResultCache",
        "dgraph_tpu_torch.engine.batcher.MicroBatcher",
        "dgraph_tpu_torch.cdc.changelog.CdcPlane",
        "dgraph_tpu_torch.cluster.client.ClusterClient"]
    ref = importlib.import_module("dgraph_tpu.utils.racecheck")
    assert [t[2] for t in racecheck.TARGETS] == [t[2] for t in ref.TARGETS]
    assert racecheck.lockcheck is lockcheck


def test_locksets_come_from_the_port_s_lockcheck():
    racecheck.enable()
    assert lockcheck.enabled()
    mb = tbatcher.MicroBatcher(db=None, window_us=0)
    with mb._lock:
        assert racecheck._lockset() == frozenset({mb._lock._name})
    racecheck.disable()
    assert not lockcheck.enabled()


PLANTED = "TestCoalescing::test_window_zero_passthrough"


def _plant_race(mp, ref_mod):
    """In the port's pass, every batcher query writes one attribute of
    the batcher from a second thread and from the caller, with no lock
    and no lifecycle edge between them."""
    if ref_mod.MicroBatcher is not tbatcher.MicroBatcher:
        return
    query_json = tbatcher.MicroBatcher.query_json

    def racy(self, *a, **kw):
        done = threading.Event()

        def other():
            self.planted = 1
            done.set()
        t = threading.Thread(target=other)
        t.start()
        done.wait(5)
        self.planted = 2
        t.join()
        return query_json(self, *a, **kw)
    mp.setattr(tbatcher.MicroBatcher, "query_json", racy)


def test_a_planted_race_fails_the_port_s_pass(tmp_path):
    """test_batcher carries the racecheck marker: its twin's port pass
    runs under the port's witness, which records the race and fails the
    pass after the reference's pass ran clean."""
    with pytest.raises(pytest.fail.Exception) as err:
        run_twins("test_batcher", [PLANTED], tmp_path, setup=_plant_race)
    msg = str(err.value)
    assert msg.startswith("dgraph_tpu_torch: violation(s) witnessed")
    assert "[dgraph_tpu_torch.utils.racecheck] data race on " \
        "`MicroBatcher.planted`" in msg
    assert not racecheck.enabled() and not lockcheck.enabled()
