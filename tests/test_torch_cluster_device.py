"""Where the port's cluster puts its engines, on the CPU.

The cluster's entry points build their engines on the card unless told
otherwise (`device`, or `--device` on the command line), and raise
without one: the cluster `AlphaServer` (through `db_kw`),
`ReplicatedGroup`, `FederatedDB`, the alphas of `ProcessCluster` and
`python -m dgraph_tpu_torch node --kind alpha`. A `ZeroServer` holds no
engine, and neither it nor a caller that asks for the CPU ever asks for
the card.
"""

from __future__ import annotations

import time

import pytest
import torch

from dgraph_tpu_torch import cli
from dgraph_tpu_torch.bench.spawn import ProcessCluster, free_ports
from dgraph_tpu_torch.cluster.federated import FederatedDB
from dgraph_tpu_torch.cluster.replica import ReplicatedGroup
from dgraph_tpu_torch.cluster.service import AlphaServer, ZeroServer

NO_CARD = "no CUDA device"


@pytest.fixture
def no_card(monkeypatch):
    """torch.cuda.is_available answering False, counting its calls."""
    asked = []

    def is_available():
        asked.append(1)
        return False
    monkeypatch.setattr(torch.cuda, "is_available", is_available)
    return asked


def _addrs():
    rp, cp = free_ports(2)
    return {1: ("127.0.0.1", rp)}, ("127.0.0.1", cp)


def _wait_leader(srv):
    end = time.monotonic() + 30
    while not srv.is_leader():
        assert time.monotonic() < end, "no leader"
        time.sleep(0.02)


def _alpha_server_defaults_to_the_card():
    peers, client = _addrs()
    with pytest.raises(RuntimeError, match=NO_CARD):
        AlphaServer(1, peers, client)
    with pytest.raises(RuntimeError, match=NO_CARD):
        AlphaServer(1, peers, client, db_kw={"rollup_window": 64})


def _replicated_group_and_federated_db_default_to_the_card():
    with pytest.raises(RuntimeError, match=NO_CARD):
        ReplicatedGroup(3)
    with pytest.raises(RuntimeError, match=NO_CARD):
        FederatedDB({}, {}, "", 1)
    assert str(FederatedDB({}, {}, "", 1, device="cpu").device) == "cpu"


def _node_command_defaults_to_the_card():
    peers, client = _addrs()
    argv = ["node", "--kind", "alpha", "--id", "1",
            "--raft-peers", f"1=127.0.0.1:{peers[1][1]}",
            "--client-addr", f"127.0.0.1:{client[1]}"]
    with pytest.raises(RuntimeError, match=NO_CARD):
        cli.main(argv)


def _zero_and_cpu_callers_never_ask_for_the_card(no_card):
    peers, client = _addrs()
    zero = ZeroServer(1, peers, client, tick_s=0.02, election_ticks=5)
    try:
        _wait_leader(zero)
    finally:
        zero.close()
    peers, client = _addrs()
    alpha = AlphaServer(1, peers, client, db_kw={"device": "cpu"},
                        tick_s=0.02, election_ticks=5)
    try:
        _wait_leader(alpha)
        assert str(alpha.db.device) == "cpu"
    finally:
        alpha.close()
    assert not no_card and not torch.cuda.is_initialized()


def _process_cluster_alphas_default_to_the_card(tmp_path):
    """Without `device` a ProcessCluster's alpha asks for the card: with
    none visible it exits at boot, saying so, while its zero serves."""
    with ProcessCluster(groups=1, replicas=1, zeros=1,
                        log_dir=str(tmp_path),
                        env_extra={"CUDA_VISIBLE_DEVICES": ""}) as pc:
        alpha = pc.procs["alpha-g1-n1"]
        assert alpha.wait(timeout=120) != 0
        assert NO_CARD in (tmp_path / "alpha-g1-n1.log").read_text()
        assert pc.procs["zero-n1"].poll() is None
        assert "--device" not in pc._node_args["alpha-g1-n1"]


def _replicated_group_replicas_share_the_device():
    """Every replica's engine, and one a restart rebuilds, runs on the
    group's `device`."""
    g = ReplicatedGroup(3, seed=3, device="cpu")
    g.alter("name: string @index(exact) .")
    g.mutate(set_nquads='_:a <name> "x" .')
    lead = g.leader_id()
    follower = next(i for i in g.dbs if i != lead)
    g.restart(follower)
    g.pump(20)
    assert {str(db.device) for db in g.dbs.values()} == {"cpu"}
    assert g.query('{ q(func: eq(name, "x")) { name } }',
                   node=follower)["data"] == {"q": [{"name": "x"}]}


def test_cluster_engines_default_to_the_card(no_card, tmp_path):
    """Each check above (one test item: see `torch_twins.run_each`); the
    zero and CPU callers' first, before anything asks."""
    _zero_and_cpu_callers_never_ask_for_the_card(no_card)
    _replicated_group_replicas_share_the_device()
    _alpha_server_defaults_to_the_card()
    _replicated_group_and_federated_db_default_to_the_card()
    _node_command_defaults_to_the_card()
    _process_cluster_alphas_default_to_the_card(tmp_path)
