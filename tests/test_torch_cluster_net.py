"""The port's networked cluster (dgraph_tpu_torch.cluster: service,
transport, client; `python -m dgraph_tpu_torch node`) against the
reference's, on the CPU.

Every case of the reference's test_cluster_net runs through both
packages (`tests/torch_twins.run_twins`): a three-node alpha group of
`node` processes (the port's as `python -m dgraph_tpu_torch node
--device cpu`), its writes, reads, stats, hedged reads, interactive
transactions, leader kills and rejoins, and the client's connection
handling. Every answer a cluster client got must equal the reference's,
masked as `torch_twins.MASKED` and `CLUSTER_MASKED` name. The twelve
cases on the module-scoped group run in one call, in file order: later
ones read what earlier ones left (the node the bank case killed); the
other four each alone, all in one test item (`torch_twins.run_each`).
In both passes the group's nodes wait 40 ticks of 30 ms for a leader,
not the file's 8 (`_patient_elections`): a leader's first query of a
shape stalls its process about 0.27 s (a reference node on a CPU
host), past 8 ticks, so a follower takes over and
the interactive transaction open on the old leader is gone. The
reference's `test_interactive_txn_over_cluster` fails alone for it,
and now and then in file order (ROADMAP Queue 3). The
reference's file carries the lockcheck and racecheck markers, which arm
its runtime witnesses (`utils/lockcheck`, `utils/racecheck`, ROADMAP
Queue 1 item 12); neither pass runs them here.
"""

from __future__ import annotations

import inspect
import subprocess

import tests.test_cluster_net as ref_net
from tests.torch_twins import reference_cases, run_each

CASES = reference_cases("test_cluster_net")
ON_GROUP = [c for c in CASES
            if "alpha" in inspect.signature(getattr(ref_net, c)).parameters]
ALONE = [c for c in CASES if c not in ON_GROUP]
ELECTION_TICKS = "40"               # the file's nodes: "8" ticks of 30 ms


def _patient_elections(mp, ref_mod):
    """Every node the pass spawns waits ELECTION_TICKS for a leader."""
    popen = subprocess.Popen            # the pass's own (the port's rewrites)

    class PatientPopen(popen):
        def __init__(self, args, *a, **kw):
            args = list(args)
            if "--election-ticks" in args:
                args[args.index("--election-ticks") + 1] = ELECTION_TICKS
            super().__init__(args, *a, **kw)
    mp.setattr(subprocess, "Popen", PatientPopen)


def test_cluster_net_through_both(tmp_path):
    assert (len(ON_GROUP), len(ALONE)) == (12, 4)
    patient = {"setup": _patient_elections}
    run_each([("test_cluster_net", ON_GROUP, patient)]
             + [("test_cluster_net", c, patient) for c in ALONE], tmp_path)
