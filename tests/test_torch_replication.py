"""The port's replicated processes (dgraph_tpu_torch.cluster: service,
client, zero, replication; bench/spawn; `python -m dgraph_tpu_torch
node`) against the reference's, on the CPU.

The reference's tests of cross-cluster replication (test_replication),
live membership (test_membership), format and protocol versions
(test_format_version) and the cluster's change streams (test_cdc's two
cluster cases) run through both packages (`tests/torch_twins.run_twins`).
In the port's pass each `python -m dgraph_tpu node` a case spawns runs
as `python -m dgraph_tpu_torch node --device cpu`, `ProcessCluster` is
the port's (its alphas on the CPU), and every answer a cluster client
got must equal the reference's, masked as `torch_twins.MASKED` and
`CLUSTER_MASKED` name. test_replication's three cases on its module-
scoped primary and standby pair run in one call, in file order, as
they share that pair in the reference's file. All of them are one test
item (`torch_twins.run_each`).
"""

from __future__ import annotations

from tests.torch_twins import reference_cases, run_each

REPLICATION = reference_cases("test_replication")
DR_PAIR = ["test_standby_tails_primary_and_reports_lag",
           "test_standby_refuses_client_writes_typed",
           "test_promote_measures_rpo_rto_and_flips_roles"]
MEMBERSHIP = reference_cases("test_membership")
FORMAT = reference_cases("test_format_version")
CDC_CLUSTER = ["test_wire_subscribe_any_replica_same_offsets",
               "test_cdc_stream_deterministic_across_process_generations"]
CASES = [("test_replication", c) for c in REPLICATION
         if c not in DR_PAIR] + \
    [("test_membership", c) for c in MEMBERSHIP] + \
    [("test_format_version", c) for c in FORMAT] + \
    [("test_cdc", c) for c in CDC_CLUSTER]


def test_replicated_processes_through_both(tmp_path):
    assert (len(REPLICATION), len(MEMBERSHIP), len(FORMAT)) == (7, 6, 7)
    assert set(DR_PAIR) < set(REPLICATION)
    assert set(CDC_CLUSTER) < set(reference_cases("test_cdc"))
    run_each(CASES + [("test_replication", DR_PAIR)], tmp_path)
