"""BENCHMARK.json keeps to its required shapes, and every cell's,
configuration's and metric's files are found by name."""

import json
import re

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    for word in BENCH["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word


def test_names_and_units_use_allowed_characters():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


def test_metric_keys_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    # each per-layer metric's cells report the end-to-end metric it moves
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                              cells))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_are_found_by_name(cell):
    entry = spec.cell_entry(BENCH, cell)
    wl = spec.workload(cell)
    assert wl["config"] == entry["config"]
    assert wl["why"] == entry["why"]
    cfg = spec.config(wl["config"])
    assert cfg["name"] == entry["config"]
    mod = spec.module("entries", wl["entry"])
    assert callable(mod.setup) and callable(mod.control)
    for trace in (False, True):
        names = [m["name"] for m in spec.metrics(BENCH, cell, trace)]
        assert names, (cell, trace)
        for name in names:
            assert callable(spec.module("metrics", name).read)
    assert "setup_s" in [m["name"] for m in spec.metrics(BENCH, cell, False)]
    for rule, _ in wl["check"]["limits"].values():
        assert rule in ("<=", ">=")


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_match(config):
    assert config["file"] == f"benchmark/configs/{config['name']}.json"
    cfg = spec.config(config["name"])
    assert cfg["source"] == config["source"]
    assert cfg["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
