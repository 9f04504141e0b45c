"""A run's check fails where the timed path is broken, and where the
control stands in the program's place; it holds on the program itself.

Each test drives the rest of a run (`harness.cell.run`) on the CPU at a
small size, past the command's look for a card, with the program's
entry point broken underneath: a level that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced. One card means no exchange between cards to leave out.
"""

import time

import pytest
import torch

from benchmark.harness import cell, spec
from benchmark_small import CELLS, small
from dgraph_tpu_torch.ops import bitgraph, knn

CPU = torch.device("cpu")
SEED = 2**31 + 424_242


def _run(cell_name):
    wl, cfg = small(cell_name)
    return cell.run(cell_name, SEED, 0.3, False, CPU, time.perf_counter(),
                    kind="NVIDIA H100 80GB HBM3", workload=wl, config=cfg)


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_program_passes(cell_name):
    out = _run(cell_name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    fam = "reach" if "reach" in cell_name else "knn"
    assert set(out["metrics"]) == {f"queries_per_s.{fam}", f"p95_ms.{fam}",
                                   "setup_s"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails(cell_name):
    wl, cfg = small(cell_name)
    ctx = cell.Context(cell_name, cfg, wl["traffic"], wl["check"], SEED, CPU)
    found = spec.module("entries", wl["entry"]).control(ctx)
    checks = cell.judge(found, wl["check"]["limits"])
    assert not all(c["holds"] for c in checks.values()), checks


def _wrap_digest(monkeypatch, fault):
    real = bitgraph.make_bfs_digest_batched

    def make(badj, core, depth, n_queries, n_seeds):
        digest = real(badj, core, depth, n_queries, n_seeds)
        first = real(badj, core, 1, n_queries, n_seeds)

        def broken(slots):
            if fault == "state_unchanged":    # levels after the first
                s1, col1 = first(slots)        # keep the first's frontier
                return s1.repeat(depth), col1
            if fault == "half_batch":
                slots = slots.clone()
                slots[n_queries // 2:] = badj.n_slots
                return digest(slots)
            sums, col = digest(slots)
            if fault == "sum_altered":
                return sums + torch.nn.functional.one_hot(
                    torch.tensor(depth - 1), depth), col
            col = col.clone()                  # "column_altered"
            col[0] ^= 1
            return sums, col
        return broken

    monkeypatch.setattr(bitgraph, "make_bfs_digest_batched", make)


# reach1 has one level: no later level to leave unchanged
@pytest.mark.parametrize("cell_name, fault", [
    (cell_name, fault)
    for cell_name in ("graph500-s20.reach3", "graph500-s20.reach1")
    for fault in ("state_unchanged", "half_batch", "sum_altered",
                  "column_altered")
    if not (fault == "state_unchanged" and cell_name.endswith("reach1"))])
def test_a_broken_digest_fails(monkeypatch, cell_name, fault):
    _wrap_digest(monkeypatch, fault)
    out = _run(cell_name)
    assert not out["correct"], out["checks"]


def _wrap_topk(monkeypatch, fault):
    real = knn.topk_device

    def broken(corpus, queries, k, metric="cosine", **kw):
        idx, sc = real(corpus, queries, k, metric, **kw)
        idx, sc = idx.copy(), sc.copy()
        if fault == "half_batch":
            h = (len(idx) + 1) // 2
            idx[h:], sc[h:] = idx[:len(idx) - h], sc[:len(idx) - h]
        else:                                  # "answer_altered"
            idx[0, 0] = (idx[0, 0] + 1) % kw["n_real"]
        return idx, sc

    monkeypatch.setattr(knn, "topk_device", broken)


# a batch of one query has no half to leave out
@pytest.mark.parametrize("cell_name, fault", [
    ("sift1m.knn-q1", "answer_altered"), ("sift1m.knn-b256", "half_batch"),
    ("sift1m.knn-b256", "answer_altered")])
def test_a_broken_search_fails(monkeypatch, cell_name, fault):
    _wrap_topk(monkeypatch, fault)
    out = _run(cell_name)
    assert not out["correct"], out["checks"]
