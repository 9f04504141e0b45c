"""The port's raft layer (dgraph_tpu_torch.cluster: raft, harness,
replica) against the reference's, on the CPU.

Every case of the reference's test_raft, test_wal_crash and test_replica,
and the cases of test_scaleout that test_torch_cold_storage does not hold
(the raft learners and the tenant QoS buckets), runs through both
packages (`tests/torch_twins.run_twins`). The deterministic harness
(`SimCluster`, seeded) must elect the same leaders and accept the same
proposals, every `RaftNode.ready()` the case drains must be equal, and
every `ReplicatedGroup` query and mutation must answer alike; the
port's replicas run on `device="cpu"`.
"""

from __future__ import annotations

from tests.torch_twins import reference_cases, run_each

RAFT = reference_cases("test_raft")
WAL_CRASH = reference_cases("test_wal_crash")
REPLICA = reference_cases("test_replica")
# test_scaleout's result-cache cases run in test_torch_cold_storage
SCALEOUT = [n for n in reference_cases("test_scaleout")
            if "learner" in n or "qos" in n]
CASES = [("test_raft", c) for c in RAFT] + \
    [("test_wal_crash", c) for c in WAL_CRASH] + \
    [("test_replica", c) for c in REPLICA] + \
    [("test_scaleout", c) for c in SCALEOUT]


def test_raft_through_both(tmp_path):
    """Each case in its own pair of passes, one after another (one test
    item: see `torch_twins.run_each`)."""
    assert (len(RAFT), len(WAL_CRASH), len(REPLICA), len(SCALEOUT)) == \
        (10, 8, 6, 8)
    run_each(CASES, tmp_path)
