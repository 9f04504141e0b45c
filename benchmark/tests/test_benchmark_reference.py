"""The plain references agree with brute force on a tiny graph and
corpus, and the reach judge reads the digest's column in any row
order."""

import numpy as np
import torch

from benchmark.harness import gen
from benchmark.reference import knn, reach

CPU = torch.device("cpu")


def _tiny_graph(seed=5, scale=8):
    src, dst = gen.kronecker(seed, scale, 16, 0.57, 0.19, 0.19, CPU)
    return src, dst, 1 << scale


def _brute_levels(src, dst, seeds, depth):
    adj = {}
    for s, d in zip(src.tolist(), dst.tolist()):
        adj.setdefault(s, []).append(d)
    seen, frontier, levels = set(seeds), set(seeds), []
    for _ in range(depth):
        nxt = {v for u in frontier for v in adj.get(u, ())} - seen
        seen |= nxt
        levels.append(nxt)
        frontier = nxt
    return levels


def test_reach_agrees_with_brute_force():
    src, dst, n = _tiny_graph()
    gr = reach.build(src, dst, n)
    seeds = gen.seed_lists(9, gen.source_uids(src), 70, 3)
    for depth in (1, 2, 3):
        ans = reach.reach(gr, seeds, depth)
        want = [0] * depth
        words = {}
        for q, row in enumerate(seeds.tolist()):
            levels = _brute_levels(src, dst, row, depth)
            for lvl, got in enumerate(levels):
                want[lvl] += len(got)
            if q < 32:
                for u in levels[-1]:
                    words[u] = words.get(u, 0) | 1 << q
        assert ans.sums == want
        assert ans.words.tolist() == sorted(words.values())
        assert ans.bit_counts == [sum(w >> q & 1 for w in words.values())
                                  for q in range(32)]


def test_reach_control_counts_paths():
    src, dst, n = _tiny_graph()
    gr = reach.build(src, dst, n)
    seeds = gen.seed_lists(4, gen.source_uids(src), 64, 8)
    for depth in (1, 2):
        ans = reach.reach(gr, seeds, depth)
        ctl = reach.reach(gr, seeds, depth, distinct=False)
        assert all(c >= a for c, a in zip(ctl.sums, ans.sums))
        assert ctl.sums != ans.sums
        assert reach.judge(ctl.sums, ctl.words[:, None], ans) > 0
        assert reach.judge(ans.sums, ans.words[:, None], ans) == 0
        flipped = ans.words.clone()
        flipped[0] ^= 1
        assert reach.judge(ans.sums, flipped, ans) > 0


def test_the_judge_reads_the_column_in_any_row_order():
    from dgraph_tpu_torch.ops import bitgraph
    src, dst, n = _tiny_graph(seed=8)
    s, d = src.numpy(), dst.numpy().astype(np.uint32)
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    edges = dict(zip(s[starts].tolist(), np.split(d, starts[1:])))
    badj = bitgraph.build_bitadjacency(edges, device="cpu")
    core = bitgraph.build_core_adjacency(badj)
    seeds = gen.seed_lists(6, gen.source_uids(src), 64, 4)
    slots = bitgraph.uid_lists_to_seed_slots(
        badj, list(seeds.numpy().astype(np.uint32)), 4)
    sums, col = bitgraph.make_bfs_digest_batched(badj, core, 2, 64, 4)(
        torch.from_numpy(slots))
    ans = reach.reach(reach.build(src, dst, n), seeds, 2)
    assert ans.words.numel() > 0
    assert reach.judge(sums.tolist(), col, ans) == 0
    shuffled = col[torch.randperm(col.shape[0])]
    assert reach.judge(sums.tolist(), shuffled, ans) == 0
    padded = torch.cat([col, torch.zeros(5, 1, dtype=col.dtype)])
    assert reach.judge(sums.tolist(), padded, ans) == 0


def test_knn_exact_agrees_with_brute_force():
    block = gen.corpus(3, 900, 1024, 8, 16, 0.25, CPU)
    qs = gen.queries(3, 12, 8, 16, 0.25, CPU)
    idx, sc = knn.exact(block, 900, qs, 5, rows=128)
    c = block[:900].double().numpy()
    d = ((qs.double().numpy()[:, None, :] - c[None]) ** 2).sum(-1)
    want = np.argsort(d, axis=1, kind="stable")[:, :5]
    assert np.array_equal(idx.numpy(), want)
    assert np.allclose(sc.numpy(), -np.take_along_axis(d, want, 1))
    found = knn.judge(block, 900, qs, idx, sc.float(), 5)
    assert found["recall_at_k"] == 1.0
    assert found["score_gap"] < 1e-4


def test_knn_judge_catches_a_wrong_row():
    block = gen.corpus(4, 900, 1024, 8, 16, 0.25, CPU)
    qs = gen.queries(4, 6, 8, 16, 0.25, CPU)
    idx, sc = knn.exact(block, 900, qs, 5)
    idx[0, 0] = (idx[0, 0] + 1) % 900
    assert knn.judge(block, 900, qs, idx, sc, 5)["score_gap"] > 1e-3
    idx[0, 0] = 950                         # a padding row
    assert knn.judge(block, 900, qs, idx, sc, 5)["score_gap"] == float("inf")


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-11,
                      -(1 + 2**-12)], dtype=torch.float32)
    got = knn.tf32(x).tolist()
    assert got == [1.0, 1 + 2**-10, 1.0, 1 + 2**-9, -1.0]
