"""The benchmark's inputs, made from `--seed` on the device it runs on.

One general generator for every cell: a configuration's data (a graph,
a vector corpus) and a traffic mix's requests (seed uid lists, query
vectors) are drawn here from the parameters in the configuration's and
the workload's JSON files. Every draw comes from a `torch.Generator` on
the run's device, in a few large calls, so the same seed on the same
device gives the same bytes, and nothing is made element by element on
the host.

Each kind of draw has its own stream (`stream`), so adding a draw of
one kind never shifts another.
"""

from __future__ import annotations

import torch

# streams of one seed: one generator each
GRAPH, SEEDS, CORPUS, QUERIES, SAMPLE = range(5)


def generator(seed: int, stream: int, device: torch.device
              ) -> torch.Generator:
    """The generator of one stream of a run's seed. Any whole number
    is a seed; it is folded into the 63 bits a generator takes."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def kronecker(seed: int, scale: int, edgefactor: int, a: float, b: float,
              c: float, device: torch.device
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Graph 500's Kronecker graph as an undirected uid graph.

    The generator is the specification's own (its sample Octave code):
    edgefactor * 2^scale edges, each placed one bit of its two endpoints
    a round, over `scale` rounds, in the quadrant the initiator
    [[a, b], [c, 1 - a - b - c]] draws; then the vertex labels are
    permuted at random. The edges' order, which the specification also
    shuffles, does not matter here: they are sorted. Each edge is kept in
    both directions, self-loops and repeated pairs are removed, and
    vertex v becomes uid v + 1 (uid 0 is no vertex). Returns the int64
    (src, dst) uid tensors sorted by (src, dst)."""
    g = generator(seed, GRAPH, device)
    n = 1 << scale
    i, j = kronecker_pairs(g, scale, edgefactor << scale, a, b, c, device)
    perm = torch.randperm(n, generator=g, device=device) + 1
    i, j = perm[i], perm[j]
    keep = i != j
    i, j = i[keep], j[keep]
    key = torch.sort(torch.cat([(i << 32) | j, (j << 32) | i]))[0]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    key = key[first]
    return key >> 32, key & 0xFFFFFFFF


def kronecker_pairs(g: torch.Generator, scale: int, m: int, a: float,
                    b: float, c: float, device: torch.device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The m edges' endpoints (int64, in [0, 2^scale)) before the
    labels are permuted: bit k of both is drawn in round k, the start's
    bit set with probability 1 - (a + b), the end's then with 1 - a/(a + b)
    where the start's is clear and 1 - c/(1 - a - b) where it is set."""
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        i_bit = torch.rand(m, generator=g, device=device) > ab
        p = torch.where(i_bit, c_norm, a_norm)
        j_bit = torch.rand(m, generator=g, device=device) > p
        i += i_bit.long() << bit
        j += j_bit.long() << bit
    return i, j


def source_uids(src: torch.Tensor) -> torch.Tensor:
    """The distinct source uids of a graph sorted by source."""
    first = torch.ones_like(src, dtype=torch.bool)
    first[1:] = src[1:] != src[:-1]
    return src[first]


def seed_lists(seed: int, sources: torch.Tensor, n_lists: int,
               n_seeds: int) -> torch.Tensor:
    """[n_lists, n_seeds] int64 seed uids, each drawn uniformly from
    `sources`, each row sorted."""
    g = generator(seed, SEEDS, sources.device)
    pick = torch.randint(0, sources.numel(), (n_lists, n_seeds),
                         generator=g, device=sources.device)
    return torch.sort(sources[pick], dim=1)[0]


def n_centers(n_rows: int, per_center: int, lo: int, hi: int) -> int:
    """The mixture's center count: n_rows / per_center within [lo, hi]."""
    return max(lo, min(hi, n_rows // per_center))


def _centers(seed: int, centers: int, dim: int, device: torch.device
             ) -> tuple[torch.Generator, torch.Tensor]:
    """The mixture's standard normal centers, the corpus stream's first
    draw, and that stream's generator."""
    g = generator(seed, CORPUS, device)
    return g, torch.randn(centers, dim, generator=g, device=device)


def corpus(seed: int, n_rows: int, n_pad: int, dim: int, centers: int,
           sigma: float, device: torch.device) -> torch.Tensor:
    """A float32 [n_pad, dim] block whose first n_rows rows are a
    mixture of Gaussians (`centers` standard normal centers, each row
    one of them plus sigma-scaled noise) and whose other rows are zero."""
    g, mid = _centers(seed, centers, dim, device)
    block = torch.zeros(n_pad, dim, dtype=torch.float32, device=device)
    pick = torch.randint(0, centers, (n_rows,), generator=g, device=device)
    block[:n_rows] = torch.randn(n_rows, dim, generator=g, device=device)
    block[:n_rows] *= sigma
    block[:n_rows] += mid[pick]
    return block


def queries(seed: int, n_queries: int, dim: int, centers: int,
            sigma: float, device: torch.device) -> torch.Tensor:
    """[n_queries, dim] float32 queries drawn from the corpus's own
    mixture (a center drawn uniformly plus sigma-scaled noise): fresh
    points, none of them a copy of a corpus row."""
    _, mid = _centers(seed, centers, dim, device)
    g = generator(seed, QUERIES, device)
    pick = torch.randint(0, centers, (n_queries,), generator=g,
                         device=device)
    out = torch.randn(n_queries, dim, generator=g, device=device)
    out *= sigma
    out += mid[pick]
    return out


def sample(seed: int, population: int, k: int) -> list[int]:
    """k distinct indices of [0, population) (all of them when k is
    larger), sorted: the requests a run checks. Drawn on the host, since
    the population is known only after the window."""
    g = generator(seed, SAMPLE, torch.device("cpu"))
    k = min(k, population)
    return sorted(torch.randperm(population, generator=g)[:k].tolist())
