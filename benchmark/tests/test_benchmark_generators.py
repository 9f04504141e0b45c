"""The generators repeat byte for byte from a seed, and differ between
seeds."""

import numpy as np
import pytest
import torch

from benchmark.harness import gen

CPU = torch.device("cpu")
BIG = 2**31 + 987_654_321          # seeds pass 32 signed bits


def _graph(seed, scale=12):
    return gen.kronecker(seed, scale, 16, 0.57, 0.19, 0.19, CPU)


def test_graph_repeats_from_a_seed():
    a, b = _graph(BIG), _graph(BIG)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = _graph(BIG + 1)
    assert not torch.equal(a[1][:1000], c[1][:1000])


def test_graph_is_undirected_sorted_distinct_without_self_loops():
    src, dst = _graph(7)
    key = src * (1 << 32) + dst
    assert bool((key[1:] > key[:-1]).all())
    assert bool((src != dst).all())
    assert torch.equal(torch.sort(dst * (1 << 32) + src)[0], key)
    assert int(src.min()) >= 1 and int(src.max()) <= 1 << 12
    # at most edgefactor * 2^scale edges, each both ways
    assert src.numel() <= 2 * 16 << 12


def test_kronecker_quadrants_follow_the_initiator():
    a, b, c = 0.57, 0.19, 0.19
    i, j = gen.kronecker_pairs(gen.generator(3, 0, CPU), 4, 400_000,
                               a, b, c, CPU)
    assert int(i.max()) < 16 and int(j.max()) < 16
    for bit in (0, 3):                   # every round draws alike
        ib, jb = (i >> bit) & 1, (j >> bit) & 1
        quad = [float(((ib == x) & (jb == y)).double().mean())
                for x in (0, 1) for y in (0, 1)]
        assert quad == pytest.approx([a, b, c, 1 - a - b - c], abs=0.004)


def test_seed_lists_repeat_and_come_from_sources():
    src, _ = _graph(11)
    sources = gen.source_uids(src)
    a = gen.seed_lists(BIG, sources, 64, 8)
    assert torch.equal(a, gen.seed_lists(BIG, sources, 64, 8))
    assert bool(torch.isin(a, sources).all())
    assert bool((a[:, 1:] >= a[:, :-1]).all())


def test_corpus_and_queries_repeat_from_a_seed():
    def make(seed):
        block = gen.corpus(seed, 1000, 1024, 16, 8, 0.25, CPU)
        return block, gen.queries(seed, 32, 16, 8, 0.25, CPU)
    (b1, q1), (b2, q2) = make(BIG), make(BIG)
    assert np.array_equal(b1.numpy(), b2.numpy())
    assert np.array_equal(q1.numpy(), q2.numpy())
    assert not bool(b1[1000:].any())          # the padding rows are zero
    b3, _ = make(BIG + 1)
    assert not torch.equal(b1, b3)


def test_queries_come_from_the_mixture_not_the_rows():
    block = gen.corpus(5, 2000, 2048, 32, 4, 0.25, CPU)
    qs = gen.queries(5, 200, 32, 4, 0.25, CPU)
    d = torch.cdist(qs, block[:2000])
    # each query lies in a cluster (near its center's rows) but on none
    # of them: sigma 0.25 in 32 dimensions puts rows about 2 apart
    assert float(d.min()) > 0.5
    assert float(d.min(1).values.max()) < 2.5


def test_sample_repeats_and_is_distinct():
    a = gen.sample(BIG, 100, 10)
    assert a == gen.sample(BIG, 100, 10)
    assert len(set(a)) == 10 and a == sorted(a)
    assert gen.sample(5, 3, 10) == [0, 1, 2]
