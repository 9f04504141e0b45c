"""Entry: the batched reach digest, `ops.bitgraph.make_bfs_digest_batched`.

Set-up makes the graph and the seed uid lists from the seed on the
card, hands the program its edges as the `{source uid: destination
uids}` map `build_bitadjacency` takes, builds the adjacency and its
core, turns each distinct batch's uid lists into the int32 [B, S] slot
matrix with the program's `uid_lists_to_seed_slots` (outside the
window), and keeps the matrices in pinned host memory.

A request is one batch: its slot matrix goes up to the card, the digest
runs, and its answer (the per-level sums and the last level's
first-word column) comes back to pinned host memory on a copy stream,
so a request waits for its own batch and not for the batches queued
behind it. The requests cycle through the distinct batches.

The check, once the window has closed, takes the batches drawn from the
seed at set-up: every returned sum of theirs, and the last column each
returned, against the reference's search over the same edges and seeds.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.harness import gen
from benchmark.reference import reach as ref
from benchmark.work import digest as work
from dgraph_tpu_torch.ops import bitgraph


def _phase(name: str, t0: float) -> float:
    """Print a set-up phase's seconds to standard error; the time now."""
    t = time.perf_counter()
    print(f"setup {name} {t - t0:.3f} s", file=sys.stderr, flush=True)
    return t


class Entry:
    def __init__(self, ctx):
        t = time.perf_counter()
        sizes, tr = ctx.config["sizes"], ctx.traffic
        dev = ctx.device
        self.dev = dev
        self.n_nodes = 1 << sizes["scale"]
        self.batch, self.n_seeds = tr["batch"], tr["seeds_per_query"]
        self.depth, self.in_flight = tr["depth"], tr["in_flight"]
        self.n_batches = tr["distinct_batches"]
        self.queries = self.batch
        self.checked = gen.sample(ctx.seed, self.n_batches,
                                  ctx.check["batches"])
        src, dst = graph(ctx.seed, sizes, dev)
        seeds = gen.seed_lists(ctx.seed, gen.source_uids(src),
                               self.n_batches * self.batch, self.n_seeds)
        # the benchmark keeps its inputs on the host during the window
        self.src, self.dst, self.seeds = src.cpu(), dst.cpu(), seeds.cpu()
        del src, dst, seeds
        t = _phase("inputs", t)
        edges = self._edge_map()
        t = _phase("edge_map", t)
        badj = bitgraph.build_bitadjacency(edges, device=dev)
        del edges
        t = _phase("build_bitadjacency", t)
        core = bitgraph.build_core_adjacency(badj)
        t = _phase("build_core_adjacency", t)
        self.n_core = core.n_core
        seed_np = self.seeds.numpy().astype(np.uint32)
        pin = dev.type == "cuda"
        self.slots = [torch.from_numpy(bitgraph.uid_lists_to_seed_slots(
            badj, list(seed_np[j * self.batch:(j + 1) * self.batch]),
            self.n_seeds)) for j in range(self.n_batches)]
        if pin:
            self.slots = [s.pin_memory() for s in self.slots]
            self.copy = torch.cuda.Stream(dev)
        _phase("seed_slots", t)
        self.digest = bitgraph.make_bfs_digest_batched(
            badj, core, self.depth, self.batch, self.n_seeds)
        self.buffers = [self._buffer(pin) for _ in range(self.in_flight)]
        self.sums: list[tuple[int, np.ndarray]] = []
        self.columns: dict[int, np.ndarray] = {}
        self.edges_followed: list[int] = []

    def _edge_map(self) -> dict:
        """{source uid: its destination uids, uint32, ascending}."""
        src = self.src.numpy()
        dst = self.dst.numpy().astype(np.uint32)
        starts = np.flatnonzero(np.r_[True, src[1:] != src[:-1]])
        return dict(zip(src[starts].tolist(), np.split(dst, starts[1:])))

    def _buffer(self, pin: bool) -> tuple[torch.Tensor, torch.Tensor]:
        sums = torch.empty(max(self.depth, 1), dtype=torch.int64)
        col = torch.empty((self.n_core + 1, 1), dtype=torch.int32)
        return (sums.pin_memory(), col.pin_memory()) if pin else (sums, col)

    def dispatch(self, i: int):
        j = i % self.n_batches
        slots = self.slots[j].to(self.dev, non_blocking=True)
        sums, col = self.digest(slots)
        col = col.contiguous()
        buf = self.buffers.pop()
        if self.dev.type != "cuda":
            buf[0].copy_(sums)
            buf[1].copy_(col)
            return j, None, buf, None
        ready = torch.cuda.Event()
        ready.record()
        with torch.cuda.stream(self.copy):
            self.copy.wait_event(ready)
            buf[0].copy_(sums, non_blocking=True)
            buf[1].copy_(col, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.copy)
        # the device tensors stay referenced until the copy is done
        return j, done, buf, (slots, sums, col)

    def wait(self, handle) -> None:
        j, done, buf, _keep = handle
        if done is not None:
            done.synchronize()
        self.sums.append((j, buf[0].numpy().copy()))
        if j in self.checked:
            self.columns[j] = buf[1].numpy().copy()
        self.buffers.append(buf)

    def free(self) -> None:
        """Drop the program's state: the adjacency, the digest, buffers."""
        self.digest = None
        self.buffers = []
        self.slots = []

    def check(self) -> dict:
        """`answer_mismatches`: over the checked batches, the levels of
        every returned answer whose sums differ from the reference's, and
        the words and query bits by which each batch's last returned
        column differs (`reference/reach.judge`)."""
        dev = self.dev
        gr = ref.build(self.src.to(dev), self.dst.to(dev), self.n_nodes)
        self.n_covered = gr.n_covered
        miss = 0
        for j in self.checked:
            seeds = self.seeds[j * self.batch:(j + 1) * self.batch].to(dev)
            ans = ref.reach(gr, seeds, self.depth)
            self.edges_followed.append(ans.edges_followed)
            got = [s for jj, s in self.sums if jj == j]
            col = self.columns.get(j)
            if not got or col is None:     # an answer that never came
                miss += self.depth + ans.words.numel() + 32
                continue
            miss += sum(ref.judge(s, None, ans) for s in got[:-1])
            miss += ref.judge(got[-1], torch.from_numpy(col), ans)
        return {"answer_mismatches": miss}

    def work(self, peaks: dict) -> dict:
        """The least seconds of a batch, from the checked batches' edges
        followed (batches are drawn alike, so their mean stands for each)."""
        edges = sum(self.edges_followed) / max(1, len(self.edges_followed))
        nbytes = work.least_bytes(self.batch, self.n_seeds, self.depth,
                                  int(edges), self.n_covered)
        return {"digest_least_s": work.least_seconds(nbytes, peaks)}


def graph(seed: int, sizes: dict, device: torch.device):
    """The configuration's Kronecker graph, from the seed."""
    return gen.kronecker(seed, sizes["scale"], sizes["edgefactor"],
                         sizes["a"], sizes["b"], sizes["c"], device)


def setup(ctx) -> Entry:
    return Entry(ctx)


def control(ctx) -> dict:
    """The numbers compared when the reference with one guarantee broken
    stands in the program's place: each level counts the (query, edge)
    path ends it reaches, not the distinct uids (`reach(distinct=False)`).
    It answers the batches a run checks, once each; no program runs."""
    sizes, tr = ctx.config["sizes"], ctx.traffic
    dev, b = ctx.device, tr["batch"]
    src, dst = graph(ctx.seed, sizes, dev)
    seeds = gen.seed_lists(ctx.seed, gen.source_uids(src),
                           tr["distinct_batches"] * b, tr["seeds_per_query"])
    gr = ref.build(src, dst, 1 << sizes["scale"])
    miss = 0
    for j in gen.sample(ctx.seed, tr["distinct_batches"],
                        ctx.check["batches"]):
        s = seeds[j * b:(j + 1) * b]
        ans = ref.reach(gr, s, tr["depth"])
        ctl = ref.reach(gr, s, tr["depth"], distinct=False)
        miss += ref.judge(ctl.sums, ctl.words[:, None], ans)
    return {"answer_mismatches": miss}
