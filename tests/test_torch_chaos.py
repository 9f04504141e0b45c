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
typed errors. All of them are one test item (`torch_twins.run_each`).
"""

from __future__ import annotations

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


def test_chaos_through_both(tmp_path):
    assert len(CHAOS) == 12 and len(DGCHAOS) == 12
    assert set(INTERLEAVED) | set(IN_PROCESS) < set(CHAOS)
    run_each([("test_chaos", c, {"compare": None if c in INTERLEAVED
                                 else "multiset"}) for c in SPAWNED]
             + [("test_chaos", IN_PROCESS)]
             + [("test_dgchaos", c, {"helpers": ("tools.dgchaos",)})
                for c in DGCHAOS], tmp_path)
