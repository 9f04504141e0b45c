"""The port's cluster under the reference's nemeses (test_chaos) and its
history checker's unit cases (test_dgchaos), on the CPU.

Every case of test_chaos runs through both packages
(`tests/torch_twins.run_twins`), the port's nodes as `python -m
dgraph_tpu_torch node --device cpu`. Each pass must keep the case's own
invariants: bank totals conserved across leader kills, tablet moves,
joins, clock skew and partitions; no out-of-order apply; a linearizable
register. Where a case drives concurrent writers against its nemeses,
how many transfers land and what each reader sees depend on the
interleaving, so those cases compare no records (`compare=None`, the
reason at the list below); the rest compare every answer. The four
in-process admission-control cases run in one call, the admission case
first: the deadline case's 100 ms budget must reach the failpointed
traversal, which a cold first query's set-up can outlast.

test_dgchaos runs with `tools/dgchaos`'s own `dgraph_tpu` names
rebound too (`helpers=`), so its error taxonomy classifies the port's
typed errors.

Each call is a test item of its own. The spawned cases hold the
reference's fixed windows (a few seconds of transfers, 20-30 s
deadlines) against write-write conflicts between concurrent writers,
so on a loaded host a pass can starve in either package, as the
reference's own test_chaos does; one starved case then fails one item,
not all of them.
"""

from __future__ import annotations

import threading
import types

import pytest

from dgraph_tpu.cluster import service as jservice
from dgraph_tpu_torch.cluster import service as tservice
from tests.torch_twins import reference_cases, run_each

CHAOS = reference_cases("test_chaos")
# concurrent bank, long-fork and register histories: how many operations
# land, their timestamps and each read's view follow the interleaving
# of writers, readers and the nemesis
INTERLEAVED = (
    "test_bank_survives_move_join_and_leader_kill",
    "test_bank_split_across_groups_survives_move_and_leader_kill",
    "test_bank_split_across_groups_survives_clock_skew",
    "test_bank_mixed_commit_now_and_2pc_transfers[no-skew]",
    "test_bank_mixed_commit_now_and_2pc_transfers[clock-skew-5s]",
    "test_long_fork_under_move_and_leader_kill",
    "test_linearizable_register_under_pause_partition",
)
IN_PROCESS = ("test_admission_control_sheds_exact_excess_with_429",
              "test_deadline_aborts_slow_query_and_frees_admission_slot",
              "test_cancellation_aborts_query_and_frees_admission_slot",
              "test_draining_rejects_writes_then_drains_idle")
SPAWNED = [c for c in CHAOS if c not in IN_PROCESS]
DGCHAOS = reference_cases("test_dgchaos")
CALLS = ([("test_chaos", c, {"compare": None if c in INTERLEAVED
                             else "multiset"}) for c in SPAWNED]
         + [("test_chaos", IN_PROCESS)]
         + [("test_dgchaos", c, {"helpers": ("tools.dgchaos",)})
            for c in DGCHAOS])


def call_id(call) -> str:
    ref_name, cases = call[0], call[1]
    case = cases if isinstance(cases, str) else "in_process"
    return f"{ref_name[len('test_'):]}-{case}".replace("[", "-").rstrip("]")


def test_the_reference_files_hold_their_cases():
    assert len(CHAOS) == 12 and len(DGCHAOS) == 12
    assert set(INTERLEAVED) | set(IN_PROCESS) < set(CHAOS)
    assert len(CALLS) == len(SPAWNED) + 1 + len(DGCHAOS) == 21


@pytest.mark.parametrize("call", CALLS, ids=call_id)
def test_chaos_through_both(call, tmp_path):
    run_each([call], tmp_path)


def pre_apply_drain(cls, commit_ts: int, decided: dict, pending) -> list:
    """The records `cls._drain_before_local_apply(commit_ts)` replicates
    on a stub leader whose zero reports `decided` ({start_ts: commit_ts})
    for the `pending` 2PC fragments."""
    applied: list = []

    class Zero:
        def request(self, req):
            c = decided.get(req["args"][0])
            return {"ok": True,
                    "result": {"decided": c is not None, "commit_ts": c}}

    leader = types.SimpleNamespace(
        _finalize_lock=threading.Lock(), lock=threading.RLock(),
        _stop=threading.Event(), zero=Zero(), _xstage_touched={},
        _xstatus_clean={},
        db=types.SimpleNamespace(pending_txns=dict.fromkeys(pending)),
        _replicate_record_locked=applied.append)
    leader._drain_finalizes_locked = \
        lambda *a, **kw: cls._drain_finalizes_locked(leader, *a, **kw)
    assert cls._drain_before_local_apply(leader, commit_ts)
    return applied


def test_local_commit_drains_only_fragments_below_its_ts():
    """A local commit reserved ts 21; while it gathers, zero has decided
    fragment 10 at 20 (before the reservation) and fragment 11 at 22
    (after it); 12 is undecided. The port applies only 10 before the
    commit, so 22 lands after 21. The reference applies 11 too, and its
    commit of 21 then fails the tablet's ts-order check (the out-of-order
    apply its own mixed chaos case meets under load)."""
    decided = {10: 20, 11: 22}
    assert pre_apply_drain(tservice.AlphaServer, 21, decided,
                           (10, 11, 12)) == [("xfinalize", 10, 20)]
    assert pre_apply_drain(jservice.AlphaServer, 21, decided,
                           (10, 11, 12)) == [("xfinalize", 10, 20),
                                             ("xfinalize", 11, 22)]
