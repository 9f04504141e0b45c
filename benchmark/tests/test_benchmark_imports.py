"""Nothing the command loads is JAX or the JAX package, compared by
whole top-level names, and a host without a card gets no result."""

import os
import subprocess
import sys

from benchmark.harness import guard

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = set(guard.FORBIDDEN)

LOAD_ALL = """
import sys
sys.path.insert(0, {root!r})
from benchmark.harness import cell, gen, guard, loop, spec, trace
from benchmark.reference import knn, reach
from benchmark.work import digest, knn as wk, peaks
bench = spec.benchmark()
for w in bench["workloads"]:
    spec.module("entries", spec.workload(w["name"])["entry"])
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.module("metrics", m["name"])
import runpy
runpy.run_path({run!r}, run_name="not_main")
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = ""
    return env


def test_the_command_loads_no_jax():
    code = LOAD_ALL.format(root=ROOT,
                           run=os.path.join(ROOT, "benchmark", "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_clean_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "dgraph_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_guard_compares_whole_names():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        sys.modules.pop("dgraph_tpu", None)
        sys.modules["dgraph_tpu_torch_x"] = sys
        assert guard.forbidden_modules() == []
        sys.modules["dgraph_tpu.ops"] = sys
        assert guard.forbidden_modules() == ["dgraph_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "graph500-s20.reach3", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, env=_clean_env(), cwd=ROOT,
        timeout=300)
    if "CUDA" in out.stderr and out.returncode != 0:
        assert out.stdout.strip() == ""
    else:   # a host with a card: the run's own test is `chip`-marked
        assert out.returncode == 0
