"""Finding a cell's pieces by name.

`BENCHMARK.json` at the root of the checkout names the cells and the
metrics. Everything else is found by name under this folder:

- `configs/<config>.json`: a configuration's sizes and guarantees;
- `workloads/<cell>.json`: a cell's entry, traffic and check limits;
- `entries/<entry>.py`: the module that drives one entry point;
- `metrics/<metric>.py`: the reader of one metric.

So a cell, a configuration or a metric is added by adding its files and
its entry in `BENCHMARK.json`, and no file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent.parent      # the benchmark folder
ROOT = HERE.parent                                 # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_entry(bench: dict, cell: str) -> dict:
    """The cell's entry in `BENCHMARK.json`."""
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json")


def workload(cell: str) -> dict:
    return load_json(HERE / "workloads" / f"{cell}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def module(kind: str, name: str) -> ModuleType:
    """`<kind>/<name>.py` of this folder, loaded by its path (a name may
    hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: the end-to-end metrics
    that list it, or name no cells (`setup_s`), or with a trace the
    per-layer metrics that list it (each lists its cells)."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", (cell,))]
