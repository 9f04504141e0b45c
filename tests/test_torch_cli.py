"""The port's command line (dgraph_tpu_torch.cli, `python -m
dgraph_tpu_torch`) against the reference's, on the CPU.

Every case of the reference's test_cli runs through both packages
(`tests/torch_twins.run_twins`), and so does
`test_pitr.py::test_cli_restore_to_ts`, whose `python -m dgraph_tpu
restore` becomes `python -m dgraph_tpu_torch restore` in the port's
pass. The port's pass sets `DGRAPH_TPU_<CMD>_DEVICE=cpu` (the CLI's
environment layer) for every command that builds an engine, since
without `--device` those engines go to the card. Responses the CLI
drew from a served Alpha (`increment`) must be equal, masked as
`torch_twins.MASKED` names.

The cluster's commands run through both packages too: `node` as the
processes a reference case spawns (`python -m dgraph_tpu_torch node
--device cpu` in the port's pass), `rebalance --once` as
test_multigroup's case drives it in process, and `standby status` and
`promote` against a zero of each package, whose printed reports must be
equal.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from dgraph_tpu_torch import cli
from tests.torch_twins import reference_cases, run_twins

REPO = Path(__file__).resolve().parent.parent
CASES = reference_cases("test_cli")
ENGINE_COMMANDS = ("alpha", "acl", "backup", "restore", "bulk", "live",
                   "export", "debug", "node", "rebalance")


def _cpu_env(mp, ref_mod):
    for cmd in ENGINE_COMMANDS:
        mp.setenv(f"DGRAPH_TPU_{cmd.upper()}_DEVICE", "cpu")


def test_the_reference_file_holds_its_cases():
    assert len(CASES) == 7


@pytest.mark.parametrize("case", CASES)
def test_cli_through_both(case, tmp_path, capsys):
    run_twins("test_cli", [case], tmp_path, capsys=capsys,
              port_setup=_cpu_env)


def _port_cli(mp, ref_mod):
    """The port's pass runs `python -m dgraph_tpu_torch`, not the
    reference's module, in the case's subprocess."""
    _cpu_env(mp, ref_mod)

    def run(args, **kw):
        args = [("dgraph_tpu_torch" if a == "dgraph_tpu" else a)
                for a in args]
        return subprocess.run(args, **kw)
    mp.setattr(ref_mod, "subprocess", types.SimpleNamespace(run=run))


def test_cli_restore_to_ts_through_both(tmp_path):
    run_twins("test_pitr", ["test_cli_restore_to_ts"], tmp_path,
              port_setup=_port_cli)


# -- the port's own rules ---------------------------------------------------


# the reference's cases that drive each cluster command
CLUSTER_COMMANDS = {
    "node": ("test_format_version", "test_hello_negotiation_on_the_wire"),
    "rebalance": ("test_multigroup", "test_rebalance_cli_once"),
}


def _standby_reports(pkg: str) -> list:
    """`standby status` and `standby promote` of `pkg`'s CLI against a
    one-node zero of `pkg`: exit codes and what each printed."""
    service = importlib.import_module(f"{pkg}.cluster.service")
    spawn = importlib.import_module(f"{pkg}.bench.spawn")
    main = importlib.import_module(f"{pkg}.cli").main
    rp, cp = spawn.free_ports(2)
    zero = service.ZeroServer(1, {1: ("127.0.0.1", rp)}, ("127.0.0.1", cp),
                              tick_s=0.02, election_ticks=5)
    out = []
    try:
        end = time.monotonic() + 30
        while not zero.is_leader():
            assert time.monotonic() < end, "no zero leader"
            time.sleep(0.02)
        for op in ("status", "promote"):
            printed, said = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(printed), \
                    contextlib.redirect_stderr(said):
                rc = main(["standby", op, "--zero", f"1=127.0.0.1:{cp}"])
            out.append((op, rc, printed.getvalue(), said.getvalue()))
    finally:
        zero.close()
    return out


@pytest.mark.parametrize("cmd", ["node", "standby", "rebalance"])
def test_cluster_command_through_both(cmd, tmp_path):
    if cmd == "standby":
        ref = _standby_reports("dgraph_tpu")
        assert _standby_reports("dgraph_tpu_torch") == ref
        assert [rc for _, rc, _, _ in ref] == [0, 1]
        return
    ref_name, case = CLUSTER_COMMANDS[cmd]
    run_twins(ref_name, [case], tmp_path, port_setup=_cpu_env)


@pytest.mark.parametrize("argv", [
    ["debug", "--wal", "{wal}", "schema"],
    ["export", "--wal", "{wal}", "--out", "{out}"],
    ["backup", "--wal", "{wal}", "{out}"],
    ["acl", "info", "--wal", "{wal}"],
])
def test_cli_engines_default_to_the_card(argv, tmp_path, monkeypatch):
    """Without --device an engine the CLI builds asks for the card,
    and raises when there is none; --device cpu runs it here."""
    wal, out = str(tmp_path / "w.log"), str(tmp_path / "out")
    argv = [a.format(wal=wal, out=out) for a in argv]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert cli.main(argv + ["--device", "cpu"]) == 0


def test_alpha_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["alpha", "--port", "0"])


def test_version_imports_no_jax():
    """`python -m dgraph_tpu_torch version` prints the package, torch
    and CUDA versions, and loads no jax and nothing of dgraph_tpu."""
    code = ("import sys, runpy; sys.argv = ['x', 'version']\n"
            "try:\n"
            "    runpy.run_module('dgraph_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'dgraph_tpu' or "
            "m.startswith('dgraph_tpu.')]\n"
            "print('LOADED', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "dgraph-tpu 0.1.0" in proc.stdout
    assert f"torch {torch.__version__}" in proc.stdout
    assert "LOADED []" in proc.stdout
