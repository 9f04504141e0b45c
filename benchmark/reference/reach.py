"""Plain reference of the batched reach digest: multi-source BFS per
query over a uid graph, in plain PyTorch, with nothing of the program.

What it answers, for a batch of B queries (each a list of seed uids)
and a depth D:

- per level l = 1..D, the sum over the batch's queries of the number of
  distinct uids that query first reaches at depth l (a uid reached
  earlier, or a seed, is not counted again), taken mod 2^32;
- the last level's first words: for each uid, the 32-bit word whose bit
  q says that query q (q < 32) first reaches it at depth D. Which row of
  its own the program puts a uid in is the program's choice, so an
  answer is judged by what does not depend on it: the sorted multiset of
  the non-zero words, and for each bit q the number of words that have
  it, which is the count of uids query q first reaches at depth D.

The search holds bitmaps of 64-bit words, [n_nodes + 1, ceil(B / 64)]:
bit q % 64 of word q // 64 of row u says that query q holds uid u. A
level ORs, for each uid, the rows of its in-neighbours: the uids are
grouped by in-degree rounded up to a power of two, each group's
in-neighbour lists padded with uid 0 (whose row is always zero) to that
width, gathered, and ORed by halving. Row 0 is no vertex.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# bytes of gathered rows a step holds at most
STEP_BYTES = 1 << 30


@dataclass
class Graph:
    """A uid graph as the reference holds it: each group of uids of one
    padded in-degree, with their in-neighbour lists, and the out-degree
    of every uid."""

    groups: list[tuple[torch.Tensor, torch.Tensor]]  # (uids [m], in [m, c])
    outdeg: torch.Tensor      # [n_nodes + 1] int64
    n_covered: int            # uids with an in-edge
    n_nodes: int


def build(src: torch.Tensor, dst: torch.Tensor, n_nodes: int) -> Graph:
    """The reference's graph from int64 (src, dst) uid edges (uids in
    [1, n_nodes]) with no repeated pair and no self-loop."""
    dev = src.device
    m = n_nodes + 1
    order = torch.sort(dst * m + src)[1]
    s, d = src[order], dst[order]
    indeg = torch.bincount(d, minlength=m)
    start = torch.cumsum(indeg, 0) - indeg
    pos = torch.arange(d.numel(), device=dev) - start[d]
    width = torch.ones_like(indeg)
    live = indeg > 0
    e = torch.ceil(torch.log2(indeg[live].double())).long()
    width[live] = torch.ones_like(e) << e
    groups = []
    for c in torch.unique(width[live]).tolist():
        uids = torch.nonzero(live & (width == c)).flatten()
        row = torch.full((m,), -1, dtype=torch.int64, device=dev)
        row[uids] = torch.arange(uids.numel(), device=dev)
        nb = torch.zeros(uids.numel(), c, dtype=torch.int64, device=dev)
        sel = row[d] >= 0
        nb[row[d[sel]], pos[sel]] = s[sel]
        groups.append((uids, nb))
    return Graph(groups, torch.bincount(src, minlength=m),
                 int(live.sum()), n_nodes)


def popcount(words: torch.Tensor) -> int:
    """Set bits of an int64 tensor, counted a byte at a time (unsigned
    bytes shift in zeros), in steps of rows."""
    flat = words.reshape(words.shape[0], -1)
    rows = max(1, STEP_BYTES // 8 // max(1, flat.shape[1]))
    total = 0
    for a in range(0, flat.shape[0], rows):
        x = flat[a:a + rows].contiguous().view(torch.uint8)
        x = x - ((x >> 1) & 0x55)
        x = (x & 0x33) + ((x >> 2) & 0x33)
        x = (x + (x >> 4)) & 0x0F
        total += int(x.sum(dtype=torch.int64))
    return total


def _level(gr: Graph, f: torch.Tensor, visited: torch.Tensor,
           ends: bool) -> tuple[torch.Tensor, int]:
    """The OR of each uid's in-neighbours' rows of `f`; with `ends`,
    also the number of (query, edge) path ends on a uid that query has
    not visited."""
    nxt = torch.zeros_like(f)
    n_ends = 0
    w = f.shape[1]
    for uids, nb in gr.groups:
        c = nb.shape[1]
        rows = max(1, STEP_BYTES // (8 * c * w))
        for a in range(0, uids.numel(), rows):
            g = f[nb[a:a + rows]]                   # [r, c, w]
            if ends:
                n_ends += popcount(g & ~visited[uids[a:a + rows]][:, None])
            while g.shape[1] > 1:
                h = g.shape[1] // 2
                g = g[:, :h] | g[:, h:]
            nxt[uids[a:a + rows]] = g[:, 0]
    return nxt, n_ends


@dataclass
class Answer:
    """A batch's answer, and the work it needed."""

    sums: list[int]           # per level, mod 2^32
    words: torch.Tensor       # the last level's non-zero first words, sorted
    bit_counts: list[int]     # per query q < 32: uids first reached at D
    # out-edges of the uids that some query's frontier holds at some
    # level before the last: each edge a query follows, counted once
    edges_followed: int = 0


def _bit_counts(words: torch.Tensor) -> list[int]:
    return [int(((words >> q) & 1).sum()) for q in range(32)]


def reach(gr: Graph, seeds: torch.Tensor, depth: int,
          distinct: bool = True) -> Answer:
    """The answer for int64 seed uids [B, S] (0 or an unknown uid seeds
    nothing). `distinct=False` is the control: a level counts every
    (query, edge) path end on a uid the query has not visited, so a uid
    reached along two edges within one level counts twice."""
    dev = seeds.device
    m = gr.n_nodes + 1
    b, w = seeds.shape[0], (seeds.shape[0] + 63) // 64
    q = torch.arange(b, device=dev)[:, None].expand_as(seeds)
    ok = (seeds > 0) & (seeds <= gr.n_nodes)
    pairs = torch.unique(q[ok] * m + seeds[ok])
    f = torch.zeros(m, w, dtype=torch.int64, device=dev)
    qq, uu = pairs // m, pairs % m
    # distinct (query, uid) pairs: adding each bit is an OR
    f.index_put_((uu, qq // 64), torch.ones_like(qq) << (qq % 64),
                 accumulate=True)
    visited = f.clone()
    active = torch.zeros(m, dtype=torch.bool, device=dev)
    sums = []
    for _ in range(depth):
        active |= (f != 0).any(1)
        nxt, n_ends = _level(gr, f, visited, not distinct)
        nxt &= ~visited
        visited |= nxt
        sums.append((popcount(nxt) if distinct else n_ends) % (1 << 32))
        f = nxt
    low = f[:, 0] & 0xFFFFFFFF
    words = torch.sort(low[low != 0])[0]
    return Answer(sums, words, _bit_counts(words),
                  int(gr.outdeg[active].sum()))


def judge(sums: list[int], column: torch.Tensor | None, ref: Answer) -> int:
    """The parts of the program's answer that differ from the
    reference's: the levels whose sums differ; and, of its last level's
    first-word column (int32, one word a row, in any order of rows), the
    words by which its multiset of non-zero words differs from the
    reference's, and the query bits 0-31 whose count of words differs
    (None compares no column)."""
    got = [int(x) for x in sums]
    miss = sum(a != b for a, b in zip(got, ref.sums)) + \
        abs(len(got) - len(ref.sums))
    if column is None:
        return miss
    col = column.reshape(-1).to(torch.int64).cpu() & 0xFFFFFFFF
    col = col[col != 0]
    want = ref.words.cpu()
    vals, inv = torch.unique(torch.cat([col, want]), return_inverse=True)
    sign = torch.cat([torch.ones_like(col), -torch.ones_like(want)])
    diff = torch.zeros(vals.numel(), dtype=torch.int64).index_add_(
        0, inv, sign)
    miss += int(diff.abs().sum())
    return miss + sum(a != b for a, b in zip(_bit_counts(col),
                                              ref.bit_counts))
