"""The port's multi-group tier (dgraph_tpu_torch.cluster: topology,
federated, zero, rebalance, shard; `rebalance` on the CLI) against the
reference's, on the CPU.

The reference's tests of predicate-sharded groups (test_multigroup),
bulk-booted groups (test_bulk_cluster) and tablet moves, splits and the
rebalancer (test_move_rebalance) run through both packages
(`tests/torch_twins.run_twins`). In the port's pass every spawned node is
`python -m dgraph_tpu_torch node --device cpu`, `ProcessCluster` and
`RoutedCluster` are the port's (the federated coordinator on the CPU),
and every answer a cluster client got must equal the reference's, masked
as `torch_twins.MASKED` and `CLUSTER_MASKED` name. The cases of
test_multigroup and test_bulk_cluster on their module-scoped cluster run
in one call, in file order, as they share that cluster in the
reference's file; test_move_rebalance's three cases on its module
cluster do not depend on each other, and each runs on its own. All of
them are one test item (`torch_twins.run_each`).
"""

from __future__ import annotations

from tests.torch_twins import reference_cases, run_each

MULTIGROUP = reference_cases("test_multigroup")
# the one case that builds no cluster
MULTIGROUP_ALONE = ["test_export_refuses_unfolded_deltas"]
BULK = reference_cases("test_bulk_cluster")
MOVES = reference_cases("test_move_rebalance")
# a writer thread commits until the move's cutover: how many of its
# writes land, and their timestamps, follow the timing
MOVES_LIVE = "test_move_under_live_writes_and_reads"


def _rebalance_on_cpu(mp, ref_mod):
    mp.setenv("DGRAPH_TPU_REBALANCE_DEVICE", "cpu")


def test_multigroup_through_both(tmp_path):
    assert (len(MULTIGROUP), len(BULK), len(MOVES)) == (26, 6, 34)
    assert set(MULTIGROUP_ALONE) < set(MULTIGROUP) and MOVES_LIVE in MOVES
    run_each([("test_multigroup", c) for c in MULTIGROUP_ALONE]
             + [("test_multigroup",
                 [c for c in MULTIGROUP if c not in MULTIGROUP_ALONE],
                 {"port_setup": _rebalance_on_cpu}),
                ("test_bulk_cluster", BULK)]
             + [("test_move_rebalance", c) for c in MOVES if c != MOVES_LIVE]
             + [("test_move_rebalance", MOVES_LIVE, {"compare": None})],
             tmp_path)
