"""The port's serving utilities (dgraph_tpu_torch.utils: reqctx, rwlock,
netfault, pprof, alerts, watchdog; reqlog.outcome_of) against the
reference's, on the CPU.

The reference's own tests of these modules run through both packages
(`tests/torch_twins.run_twins`): once as they are, once with their
`dgraph_tpu` names bound to the port's. Whatever either pass serves
over HTTP, and every answer a cluster client got, must be equal, masked
as `torch_twins.MASKED` names. The cases of test_reqctx and
test_netfault that drive `cluster/` (federated tasks, the cluster client
and transport, RaftServer), in `CLUSTER_CASES`, run as one test item
(`torch_twins.run_each`).
"""

from __future__ import annotations

import pytest

from dgraph_tpu.cluster.coordinator import TxnAborted as JTxnAborted
from dgraph_tpu.utils import reqctx as jreqctx
from dgraph_tpu.utils import reqlog as jreqlog
from dgraph_tpu_torch.cluster.coordinator import TxnAborted as TTxnAborted
from dgraph_tpu_torch.utils import reqctx as treqctx
from dgraph_tpu_torch.utils import reqlog as treqlog
from tests.torch_twins import reference_cases, run_each, run_twins

CLUSTER_CASES = {
    "test_reqctx": (
        "test_federated_tasks_carry_remaining_budget",
        "test_federated_task_refused_after_deadline",
        "test_worker_inherits_budget_with_skew_allowance",
        "test_client_routed_retry_stops_at_deadline_during_election",
        "test_client_deadline_bounds_stalled_socket_read"),
    "test_netfault": (
        "test_transport_drop_cut_and_heal",
        "test_transport_duplicate_delivers_twice",
        "test_client_partition_fails_fast_typed_and_heals",
        "test_backoff_is_bounded_jittered_and_grows",
        "test_peer_ages_and_fault_wire_op",
        "test_debug_stats_payload_carries_fault_plane"),
}
FILES = ("test_reqctx", "test_rwlock", "test_netfault", "test_pprof",
         "test_alerts", "test_watchdog")
CASES = [(f, name) for f in FILES
         for name in reference_cases(f, CLUSTER_CASES.get(f, ()))]


def test_the_reference_files_hold_their_cases():
    counts = {f: sum(1 for g, _ in CASES if g == f) for f in FILES}
    assert counts == {"test_reqctx": 13 - 5, "test_rwlock": 10,
                      "test_netfault": 15 - 6, "test_pprof": 7,
                      "test_alerts": 19, "test_watchdog": 17}


@pytest.mark.parametrize("ref_name,case", CASES,
                         ids=[f"{f}::{c}" for f, c in CASES])
def test_serving_utils_through_both(ref_name, case, tmp_path):
    run_twins(ref_name, [case], tmp_path)


def test_cluster_cases_through_both(tmp_path):
    run_each([(f, c) for f, cases in CLUSTER_CASES.items() for c in cases],
             tmp_path)


# -- reqlog.outcome_of -------------------------------------------------------


def _errors(reqctx, txn_aborted):
    return [reqctx.Overloaded("shed"), reqctx.DeadlineExceeded("late"),
            reqctx.Cancelled("gone"), txn_aborted("conflict"),
            ValueError("plain"), reqctx.RequestAborted("other")]


def test_outcome_of_classifies_alike():
    """The port's reqlog.outcome_of (its lazy import of utils/reqctx
    resolves now) classifies each request-killing error as the
    reference's does."""
    ref = [jreqlog.outcome_of(e) for e in _errors(jreqctx, JTxnAborted)]
    port = [treqlog.outcome_of(e) for e in _errors(treqctx, TTxnAborted)]
    assert port == ref == ["shed", "deadline", "cancelled", "aborted",
                           "error", "error"]
