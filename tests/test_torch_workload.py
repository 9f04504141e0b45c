"""The port's workload generator (dgraph_tpu_torch.bench.workload)
against the reference's, on the CPU, with no tolerance.

Determinism is the generator's contract: the same config gives
byte-identical schema, quads and op lines in any process and in either
package. The reference's own tests (tests/test_workload.py) run through
both packages (`tests/torch_twins.run_twins`); then, for every seed,
scale and mix below, the two packages' schema, quads, op lines and
`stream_digest` must be byte-equal, and a fresh interpreter that imports
only the port's module must print the reference's digests.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import pytest

from dgraph_tpu.bench import workload as jwl
from dgraph_tpu_torch.bench import workload as twl
from tests.torch_twins import reference_cases, run_twins

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = reference_cases("test_workload")
SEEDS = (1, 7, 20260803)
PERSONS = (80, 240, 4096)
N_OPS = 600


def test_the_reference_file_holds_its_cases():
    assert len(CASES) == 7 and len(KINDS) == 10


@pytest.mark.parametrize("case", CASES)
def test_workload_through_both(case, tmp_path):
    run_twins("test_workload", [case], tmp_path)


def test_the_constants_are_the_reference_s():
    for name in ("FIRST", "LAST", "CITIES", "TOPICS", "SCHEMA",
                 "DEFAULT_MIX", "ZIPF_READ_MIX", "MIXES", "ZIPF_S"):
        assert getattr(twl, name) == getattr(jwl, name), name
    assert twl.WorkloadConfig() == twl.WorkloadConfig(**vars(
        jwl.WorkloadConfig()))


# what each case compares: the graph (schema and read predicates, the
# quads) and the op stream (its lines, its digests)
PARTS = ("schema", "quads", "ops", "digests")


def _part(wl, seed, persons, mix, part):
    w = wl.Workload(wl.WorkloadConfig(seed=seed, persons=persons,
                                      mix=wl.MIXES[mix]))
    if part == "schema":
        return w.schema(), w.read_predicates()
    if part == "quads":
        return w.quads()
    if part == "ops":
        return [op.to_line() for op in w.ops(N_OPS, stream_seed=3)]
    return (wl.stream_digest(w.ops(N_OPS, stream_seed=3)),
            wl.stream_digest(w.ops(64)))


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("mix", sorted(jwl.MIXES))
@pytest.mark.parametrize("persons", PERSONS)
@pytest.mark.parametrize("seed", SEEDS)
def test_byte_equal_across_packages(seed, persons, mix, part):
    got = _part(twl, seed, persons, mix, part)
    assert got == _part(jwl, seed, persons, mix, part)
    if part == "quads":
        assert len(got) == persons * (4 + 8) + persons * 2 * 3
    if part == "ops":
        assert len(got) == N_OPS


KINDS = sorted({k for mix in jwl.MIXES.values() for k, _ in mix})


@pytest.mark.parametrize("seed", SEEDS + (42,))
@pytest.mark.parametrize("kind", KINDS)
def test_each_op_kind_equal(kind, seed):
    """Every op kind drawn alone, 50 times from one stream: the same
    lines, and the generator's RNG in the same state after each."""
    import random

    lines = {}
    for side, wl in (("ref", jwl), ("port", twl)):
        w = wl.Workload(wl.WorkloadConfig(seed=seed, persons=240))
        rng = random.Random(f"{seed}:{kind}")
        lines[side] = [(w._one(kind, i, rng).to_line(), rng.random())
                       for i in range(50)]
    assert lines["port"] == lines["ref"]
    assert len({line for line, _ in lines["port"]}) > 1


def _digests(wl):
    w = wl.Workload(wl.WorkloadConfig(seed=20260803, persons=240))
    return {"quads": hashlib.sha256(
        "\n".join(w.quads()).encode()).hexdigest(),
        "ops": wl.stream_digest(w.ops(128, stream_seed=5))}


def test_a_port_only_process_prints_the_reference_digest():
    """A fresh interpreter (another hash seed) that imports only the
    port's module, and neither jax nor the reference package."""
    prog = ("import hashlib, json, sys\n"
            "from dgraph_tpu_torch.bench import workload as wl\n"
            "w = wl.Workload(wl.WorkloadConfig(seed=20260803, persons=240))\n"
            "print(json.dumps({'quads': hashlib.sha256('\\n'.join("
            "w.quads()).encode()).hexdigest(), 'ops': wl.stream_digest("
            "w.ops(128, stream_seed=5)), 'loaded': sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'dgraph_tpu'))}))\n")
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED="4242")
    out = subprocess.run([sys.executable, "-c", prog], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-800:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got.pop("loaded") == []
    assert got == _digests(jwl) == _digests(twl)
