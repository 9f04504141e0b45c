"""The port's gather-OR (dgraph_tpu_torch.ops.kernels) on the CPU: its
plain version against the TPU kernel run in interpret mode and against
the reference's XLA gather path, and the wrapper's checks.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against the plain version there.
"""

import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgraph_tpu.ops.bitgraph import _gather_or
from dgraph_tpu.ops.pallas_kernels import bucket_or_pallas
from dgraph_tpu_torch.ops import _build, kernels
from dgraph_tpu_torch.ops import knn as tknn


def frontier(n, width, seed):
    """Random uint32 words [n+1, width] with the dummy row n all zero,
    and the same bits as an int32 tensor."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 2**32, (n + 1, width), dtype=np.uint32)
    f[n] = 0
    return f, torch.from_numpy(f.view(np.int32).copy())


def in_neighbours(n, m, d, seed):
    """int32 [m, d] indices into [0, n], padding (n) mixed in."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, n + 1, (m, d)).astype(np.int32)
    nb.reshape(-1)[::5] = n
    return nb


@pytest.mark.parametrize("m,d", [(7, 1), (50, 3), (5, 8), (2, 100),
                                 (3, 13)])
def test_reference_matches_pallas_interpret(m, d):
    f, ft = frontier(40, 128, seed=m * 100 + d)
    nb = in_neighbours(40, m, d, seed=d)
    want = np.asarray(bucket_or_pallas(jnp.asarray(f), jnp.asarray(nb),
                                       interpret=True))
    got = kernels.bucket_or_reference(ft, torch.from_numpy(nb))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("width", [1, 5, 33])
@pytest.mark.parametrize("degree", [1, 2, 3, 4, 6, 12, 100, 257])
def test_reference_matches_jax_gather_or(width, degree):
    f, ft = frontier(60, width, seed=width * 1000 + degree)
    nb = in_neighbours(60, 9, degree, seed=degree)
    want = np.asarray(_gather_or(jnp.asarray(f), jnp.asarray(nb), degree))
    got = kernels.bucket_or_reference(ft, torch.from_numpy(nb))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        want, np.bitwise_or.reduce(f[nb], axis=1))


# bucket_or's cuts on the card: a degree-1 bucket (whole-row units), a
# row one past a chunk unit, and a hub of several chunks
CARD_SHAPES = {"degree-1": (300, 1), "split": (2, kernels.OR_SPAN + 1),
               "hub": (1, 4 * kernels.OR_SPAN + 24)}


@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("width", [1, 2, 3])
def test_reference_matches_jax_gather_or_on_narrow_rows(width, shape):
    m, d = CARD_SHAPES[shape]
    f, ft = frontier(700, width, seed=width * 10 + d)
    nb = in_neighbours(700, m, d, seed=d)
    want = np.asarray(_gather_or(jnp.asarray(f), jnp.asarray(nb), d))
    got = kernels.bucket_or_reference(ft, torch.from_numpy(nb))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_reference_matches_pallas_interpret_at_card_shapes(shape):
    m, d = CARD_SHAPES[shape]
    f, ft = frontier(700, 128, seed=d)
    nb = in_neighbours(700, m, d, seed=m + d)
    want = np.asarray(bucket_or_pallas(jnp.asarray(f), jnp.asarray(nb),
                                       interpret=True))
    got = kernels.bucket_or_reference(ft, torch.from_numpy(nb))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def kernel_cover(plan, m, degree, width):
    """bucket_or_kernel's walk over a launch, written out from the CUDA
    source: how often each (row, in-neighbour) is gathered on each tile,
    and each vector of a row is held by a lane."""
    wv = width // plan.vec
    groups = 32 // plan.lanes
    lanes = np.zeros(wv, np.int64)
    for t in range(plan.ntiles):
        for j in range(plan.lanes):
            if t * plan.lanes + j < wv:
                lanes[t * plan.lanes + j] += 1
    pairs = np.zeros((plan.ntiles, m, degree), np.int64)
    for u in range(plan.units):
        base, t = divmod(u, plan.ntiles)     # tile-minor
        if plan.rows_unit:
            # group g takes rows g, g + groups, ... with all of their
            # in-neighbours
            m0 = base * plan.rows_unit
            rows = min(plan.rows_unit, m - m0)
            assert rows * degree <= kernels.OR_SPAN
            for g in range(groups):
                pairs[t, m0 + g:m0 + rows:groups, :] += 1
        else:
            # group g takes in-neighbours g, g + groups, ...
            m0, c = divmod(base, plan.nchunks)
            d0 = c * plan.chunk
            n = min(plan.chunk, degree - d0)
            assert n <= kernels.OR_SPAN
            for g in range(groups):
                pairs[t, m0, d0 + g:d0 + n:groups] += 1
    return lanes, pairs


# (M, D, W, alignment): level 1's degree-1 bucket and a core hub at W
# 768, the reach path's W 2 and its hub, the card checks' edges (D 16/17
# between unit kinds, 255-257 around a chunk, a hub), unaligned and odd
# widths
PLAN_CASES = [
    (3000, 1, 768, 16), (2, 3000, 768, 16), (1, 2_097_152, 2, 16),
    (100, 12, 2, 8), (1, (1 << 20) + 24, 128, 16), (70, 16, 768, 16),
    (70, 17, 768, 16), (9, 255, 1100, 16), (9, 256, 1100, 4),
    (9, 257, 1100, 16), (20, 16, 5, 4), (20, 17, 3, 4), (33, 2, 2, 8),
    (7, 3, 2, 4), (40, 1, 1, 16), (5, 300, 37, 16), (77, 5, 1100, 8),
]
# and a grid: widths of one to 275 vectors, each vector size, degrees on
# both sides of OR_ROW_MAX_D and of a chunk, 37 rows (a partial row unit)
PLAN_CASES += [(37, d, w, 16) for w in (1, 2, 3, 4, 5, 33, 129, 1100)
               for d in (1, 2, 15, 16, 17, 255, 257, 600)]


@pytest.mark.parametrize("m,degree,width,align", PLAN_CASES)
def test_plan_covers_every_row_in_neighbour_and_word_once(m, degree, width,
                                                          align):
    plan = kernels.bucket_or_plan(m, degree, width, align)
    wv = width // plan.vec
    # what the launcher accepts
    assert width % plan.vec == 0 and align % (4 * plan.vec) == 0
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    assert plan.ntiles == 1 or plan.lanes == 32
    assert (plan.ntiles - 1) * plan.lanes < wv <= plan.ntiles * plan.lanes
    if plan.rows_unit:
        assert degree <= kernels.OR_ROW_MAX_D
        assert plan.rows_unit <= 32 and plan.chunk == degree
        assert plan.nchunks == 1
        assert plan.units == plan.ntiles * -(-m // plan.rows_unit)
    else:
        assert degree > kernels.OR_ROW_MAX_D
        assert plan.chunk == kernels.OR_SPAN
        assert plan.nchunks == -(-degree // plan.chunk)
        assert plan.units == plan.ntiles * m * plan.nchunks
    assert plan.scratch_words == (m * width + m * plan.ntiles
                                  if plan.nchunks > 1 else 0)
    lanes, pairs = kernel_cover(plan, m, degree, width)
    assert (lanes == 1).all() and (pairs == 1).all()


def test_plan_takes_the_widest_vector_the_row_and_pointers_allow():
    assert kernels.bucket_or_plan(10, 1, 768, 16)[:3] == (4, 32, 6)
    assert kernels.bucket_or_plan(10, 1, 768, 8)[:3] == (2, 32, 12)
    assert kernels.bucket_or_plan(10, 1, 2, 16)[:3] == (2, 1, 1)
    assert kernels.bucket_or_plan(10, 1, 2, 4)[:3] == (1, 2, 1)
    assert kernels.bucket_or_plan(10, 1, 5, 16)[:3] == (1, 8, 1)


@pytest.mark.parametrize("args", [
    (0, 1, 1, 16), (1, 0, 1, 16), (1, 1, 0, 16), (1, 1, 1, 3),
    (1, 1, 1, 32)])
def test_plan_rejects(args):
    with pytest.raises(ValueError):
        kernels.bucket_or_plan(*args)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 11])
def test_or_reduce_dim1(k):
    rng = np.random.default_rng(k)
    x = rng.integers(0, 2**32, (4, k, 6), dtype=np.uint32)
    got = kernels._or_reduce_dim1(torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.bitwise_or.reduce(x, axis=1))


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    f, ft = frontier(30, 7, seed=1)
    nb = torch.from_numpy(in_neighbours(30, 12, 4, seed=2))
    before = kernels.bucket_or.launches
    got = kernels.bucket_or(ft, nb)
    assert kernels.bucket_or.launches == before
    assert torch.equal(got, kernels.bucket_or_reference(ft, nb))


def test_wrapper_writes_into_out_slice():
    _, ft = frontier(30, 7, seed=3)
    nb = torch.from_numpy(in_neighbours(30, 12, 4, seed=4))
    big = torch.full((14, 7), 7, dtype=torch.int32)
    res = kernels.bucket_or(ft, nb, out=big[1:13])
    assert res.data_ptr() == big[1:13].data_ptr()
    assert torch.equal(big[1:13], kernels.bucket_or_reference(ft, nb))
    assert bool((big[0] == 7).all()) and bool((big[13] == 7).all())


def _bad_inputs(case):
    f = torch.zeros((10, 4), dtype=torch.int32)
    nb = torch.zeros((3, 2), dtype=torch.int32)
    out = None
    if case == "f_dtype":
        f = f.to(torch.int64)
    elif case == "nb_dtype":
        nb = nb.to(torch.int64)
    elif case == "f_rank":
        f = f.reshape(-1)
    elif case == "non_contiguous":
        f = torch.zeros((4, 10), dtype=torch.int32).t()
    elif case == "out_shape":
        out = torch.zeros((3, 5), dtype=torch.int32)
    elif case == "out_dtype":
        out = torch.zeros((3, 4), dtype=torch.int64)
    elif case == "out_strided":
        out = torch.zeros((3, 8), dtype=torch.int32)[:, ::2]
    elif case == "device":
        f, nb = f.to("meta"), nb.to("meta")
    elif case == "mixed_devices":
        nb = nb.to("meta")
    return f, nb, out


@pytest.mark.parametrize("case", [
    "f_dtype", "nb_dtype", "f_rank", "non_contiguous", "out_shape",
    "out_dtype", "out_strided", "device", "mixed_devices"])
def test_wrapper_rejects(case):
    f, nb, out = _bad_inputs(case)
    with pytest.raises((TypeError, ValueError)):
        kernels.bucket_or(f, nb, out=out)


def test_build_targets_hopper_and_lands_in_ignored_build_dir():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
    path = _build.library_path("bucket_or")
    assert path.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "dgraph_tpu_torch")
    assert (_build.CSRC_DIR / "bucket_or.cu").exists()


def test_build_failure_raises(monkeypatch, tmp_path):
    """A failed build is an error, never a quiet switch to the plain
    version."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load("bucket_or")
    assert not list(tmp_path.glob("*.so"))


# -- bucket_or_level: the fused BFS level step ---------------------------------


def masks_by_hand(words):
    """uint32 [R, W] -> the exact occupancy mask of each row, a Python
    int per row, one segment (32 words, widened past W 1,024) at a time."""
    width = words.shape[1]
    seg = 32 * max(1, -(-width // 1024))
    return [sum(1 << s for s in range(-(-width // seg))
                if row[s * seg:(s + 1) * seg].any()) for row in words]


def as_int32(masks):
    return torch.from_numpy(np.asarray(masks, np.uint32).view(np.int32))


def sparse_frontier(n, width, seed):
    """uint32 [n+1, width] with about one bit a row (some rows empty) and
    the dummy row n zero."""
    rng = np.random.default_rng(seed)
    f = np.zeros((n + 1, width), np.uint32)
    rows = rng.choice(n, n // 2, replace=False)
    col = rng.integers(0, 32 * width, len(rows))
    f[rows, col // 32] = np.uint32(1) << (col % 32).astype(np.uint32)
    return f, torch.from_numpy(f.view(np.int32).copy())


@pytest.mark.parametrize("width", [1, 5, 33, 768, 1100, 2048])
def test_segment_masks_exact(width):
    f, ft = sparse_frontier(70, width, seed=width)
    f[3] = 0xFFFFFFFF                       # every segment, bit 31 too
    ft = torch.from_numpy(f.view(np.int32).copy())
    got = kernels.segment_masks(ft)
    assert got.dtype == torch.int32
    assert got.numpy().view(np.uint32).tolist() == masks_by_hand(f)
    assert kernels.segment_words(width) == 32 * max(1, -(-width // 1024))


@pytest.mark.parametrize("width", [1, 5, 37, 768, 1100])
@pytest.mark.parametrize("density", ["sparse", "dense"])
@pytest.mark.parametrize("row_map", [False, True])
def test_level_reference_matches_composition(width, density, row_map):
    """bucket_or_level_reference against the digest's old composition:
    the gather-OR (the reference's `_gather_or` and `bucket_or_reference`),
    the and-not, the or, `popcount_sum` and masks computed by hand."""
    n, m, d = 60, 9, 13
    if density == "sparse":
        f, ft = sparse_frontier(n, width, seed=width)
    else:
        f, ft = frontier(n, width, seed=width)
    nb = in_neighbours(n, m, d, seed=width + 1)
    nb[2] = n                               # an all-padding row
    rng = np.random.default_rng(width + 2)
    before = rng.integers(0, 2**32, (m, width), dtype=np.uint32) & \
        rng.integers(0, 2**32, (m, width), dtype=np.uint32)
    before_t = torch.from_numpy(before.view(np.int32).copy())
    reach = np.asarray(_gather_or(jnp.asarray(f), jnp.asarray(nb), d))
    np.testing.assert_array_equal(
        kernels.bucket_or_reference(ft, torch.from_numpy(nb)).numpy()
        .view(np.uint32), reach)
    new = reach & ~before
    want_total = 7 + int(kernels.popcount_sum(
        torch.from_numpy(new.view(np.int32).copy())))
    assert want_total == 7 + int(np.unpackbits(new.view(np.uint8)).sum())

    n_out = m + 3 if row_map else m
    rows = rng.permutation(n_out)[:m]
    frontier_t = torch.full((n_out, width), 7, dtype=torch.int32)
    visited_t = torch.full((n_out, width), 9, dtype=torch.int32)
    out_mask = torch.full((n_out,), 5, dtype=torch.int32)
    total = torch.tensor([7])
    kw = {}
    if row_map:
        kw = dict(seeds=before_t, seeds_mask=as_int32(masks_by_hand(before)),
                  rows=torch.from_numpy(rows.astype(np.int32)))
    else:
        visited_t.copy_(before_t)
        rows = np.arange(m)
    kernels.bucket_or_level_reference(ft, as_int32(masks_by_hand(f)),
                                      torch.from_numpy(nb), frontier_t,
                                      visited_t, out_mask, total, **kw)
    got_f = frontier_t.numpy().view(np.uint32)
    got_v = visited_t.numpy().view(np.uint32)
    np.testing.assert_array_equal(got_f[rows], new)
    np.testing.assert_array_equal(got_v[rows], before | new)
    assert out_mask.numpy().view(np.uint32)[rows].tolist() == \
        masks_by_hand(new)
    assert int(total) == want_total
    untouched = np.setdiff1d(np.arange(n_out), rows)
    assert (got_f[untouched] == 7).all() and (got_v[untouched] == 9).all()
    assert (out_mask.numpy()[untouched] == 5).all()


def test_level_reference_honours_masks():
    """A mask bit cleared over a non-zero segment drops that segment from
    the gather (and a seed segment from visited), as the kernel does: a
    wrong mask gives a wrong answer on the CPU too."""
    width, n = 70, 4                        # 3 segments, the last partial
    f = np.zeros((n + 1, width), np.uint32)
    f[0, 40] = 1 << 3                       # segment 1 of row 0
    f[1, 65] = 1 << 31                      # segment 2 of row 1
    ft = torch.from_numpy(f.view(np.int32).copy())
    nb = torch.tensor([[0, 1, n]], dtype=torch.int32)
    exact = as_int32(masks_by_hand(f))
    assert exact.numpy().view(np.uint32).tolist() == [2, 4, 0, 0, 0]

    def run(mask, seeds_mask=None):
        fr = torch.zeros((1, width), dtype=torch.int32)
        vis = torch.zeros((1, width), dtype=torch.int32)
        om = torch.zeros(1, dtype=torch.int32)
        total = torch.zeros(1, dtype=torch.int64)
        kw = {}
        if seeds_mask is not None:
            seeds = np.zeros((1, width), np.uint32)
            seeds[0, 2] = 5                 # segment 0
            kw = dict(seeds=torch.from_numpy(seeds.view(np.int32)),
                      seeds_mask=torch.tensor([seeds_mask],
                                              dtype=torch.int32),
                      rows=torch.zeros(1, dtype=torch.int32))
        kernels.bucket_or_level_reference(ft, mask, nb, fr, vis, om, total,
                                          **kw)
        return fr.numpy().view(np.uint32), vis.numpy().view(np.uint32), \
            int(om), int(total)

    fr, _, om, total = run(exact)
    assert fr[0, 40] == 1 << 3 and fr[0, 65] == 1 << 31
    assert (om, total) == (6, 2)
    thinned = exact.clone()
    thinned[1] = 0                          # row 1's segment 2 cleared
    fr, _, om, total = run(thinned)
    assert fr[0, 40] == 1 << 3 and fr[0, 65] == 0
    assert (om, total) == (2, 1)
    # a seed segment whose bit is clear is not read either
    _, vis, _, _ = run(exact, seeds_mask=1)
    assert vis[0, 2] == 5
    _, vis, _, _ = run(exact, seeds_mask=0)
    assert vis[0, 2] == 0


def full_by_hand(words):
    """uint32 [R, W] -> the exact saturation mask of each row, a Python
    int per row: bit s iff every word of segment s inside W is all ones."""
    width = words.shape[1]
    seg = 32 * max(1, -(-width // 1024))
    return [sum(1 << s for s in range(-(-width // seg))
                if (row[s * seg:(s + 1) * seg] == 0xFFFFFFFF).all())
            for row in words]


def saturated_rows(m, width, seed):
    """uint32 [m, W] visited rows: random, every third row all ones, every
    third from the second full in its first segment, and row 2 all ones
    but for one bit of its last word (the partial segment's)."""
    rng = np.random.default_rng(seed)
    vis = rng.integers(0, 2**32, (m, width), dtype=np.uint32) | \
        rng.integers(0, 2**32, (m, width), dtype=np.uint32)
    vis[0::3] = 0xFFFFFFFF
    vis[1::3, :32 * max(1, -(-width // 1024))] = 0xFFFFFFFF
    vis[2] = 0xFFFFFFFF
    vis[2, -1] = 0xFFFFFFFE
    return vis


@pytest.mark.parametrize("width", [1, 5, 37, 768, 1100])
def test_full_masks_exact(width):
    """A bit is set iff every word of its segment inside W is all ones:
    whole rows, a first segment, the partial last segment, bit 31 and the
    all-zero dummy row."""
    vis = saturated_rows(12, width, seed=width)
    vis = np.concatenate([vis, np.zeros((1, width), np.uint32)])
    got = kernels.full_masks(torch.from_numpy(vis.view(np.int32).copy()))
    assert got.dtype == torch.int32
    want = full_by_hand(vis)
    assert got.numpy().view(np.uint32).tolist() == want
    nseg = -(-width // kernels.segment_words(width))
    assert want[0] == (1 << nseg) - 1 and want[-1] == 0
    assert want[2] == ((1 << nseg) - 1) & ~(1 << (nseg - 1))


def _level_case(width, m, degree, seed):
    """A dense frontier with its masks, in_nb with padding and an
    all-padding row, and saturated visited rows."""
    n = 50
    f, ft = frontier(n, width, seed=seed)
    nb = in_neighbours(n, m, degree, seed=seed + 1)
    nb[min(4, m - 1)] = n
    vis = saturated_rows(m, width, seed=seed + 2)
    return ft, as_int32(masks_by_hand(f)), torch.from_numpy(nb), \
        torch.from_numpy(vis.view(np.int32).copy())


def _run_level(ft, mask, nb, vis, full=None, pairs=False, row_map=False):
    m, width = nb.shape[0], ft.shape[1]
    out = dict(frontier=torch.full((m, width), 7, dtype=torch.int32),
               visited=vis.clone(),
               out_mask=torch.full((m,), 5, dtype=torch.int32),
               total=torch.zeros(1, dtype=torch.int64),
               full=None if full is None else full.clone(),
               pairs=torch.zeros(2, dtype=torch.int64) if pairs else None)
    kw = {}
    if row_map:                         # level 1: visited is the seeds
        kw = dict(seeds=vis, seeds_mask=kernels.segment_masks(vis),
                  rows=torch.arange(m, dtype=torch.int32))
    kernels.bucket_or_level_reference(
        ft, mask, nb, out["frontier"], out["visited"], out["out_mask"],
        out["total"], full=out["full"], pairs=out["pairs"], **kw)
    return out


@pytest.mark.parametrize("width", [1, 5, 37, 768, 1100])
@pytest.mark.parametrize("degree", [1, 13, kernels.LEVEL_CHUNK + 1])
@pytest.mark.parametrize("row_map", [False, True])
def test_level_reference_full_mask_changes_no_answer(width, degree,
                                                     row_map):
    """With the exact full mask the frontier, visited, out mask and sum are
    those of an all-zero mask (which skips nothing) and of no mask, in
    place and at level 1, for split rows too; the mask comes back exact."""
    ft, mask, nb, vis = _level_case(width, 9, degree, seed=width + degree)
    exact = kernels.full_masks(vis)
    assert int((exact != 0).sum()) >= 6
    runs = [_run_level(ft, mask, nb, vis, full, row_map=row_map)
            for full in (None, exact, torch.zeros_like(exact))]
    for k in ("frontier", "visited", "out_mask", "total"):
        for r in runs[1:]:
            assert torch.equal(r[k], runs[0][k]), k
    assert torch.equal(runs[1]["full"],
                       kernels.full_masks(runs[1]["visited"]))


def test_level_reference_honours_full_mask():
    """A full bit set over a segment that is not full drops that segment's
    gather, as the kernel does (a wrong mask gives the kernel's wrong
    answer), and the bit stands where no new bit lands; at level 1 the
    mask is written, never read."""
    width, n = 70, 4                        # 3 segments, the last partial
    f = np.zeros((n + 1, width), np.uint32)
    f[0, 40] = 1 << 3                       # segment 1 of row 0
    f[1, 65] = 1 << 31                      # segment 2 of row 1
    ft = torch.from_numpy(f.view(np.int32).copy())
    mask = as_int32(masks_by_hand(f))
    nb = torch.tensor([[0, 1, n]], dtype=torch.int32)
    vis = torch.zeros((1, width), dtype=torch.int32)
    right = _run_level(ft, mask, nb, vis, torch.zeros(1, dtype=torch.int32))
    wrong = _run_level(ft, mask, nb, vis, torch.tensor([2], dtype=torch.int32))
    fr = wrong["frontier"].numpy().view(np.uint32)
    assert right["frontier"].numpy().view(np.uint32)[0, 40] == 1 << 3
    assert fr[0, 40] == 0 and fr[0, 65] == 1 << 31
    assert (int(wrong["out_mask"]), int(wrong["total"])) == (4, 1)
    assert int(wrong["full"]) == 2          # segment 1 kept its bit
    assert int(right["full"]) == 0
    level1 = _run_level(ft, mask, nb, vis, torch.tensor([2], dtype=torch.int32),
                        row_map=True)
    assert level1["frontier"].numpy().view(np.uint32)[0, 40] == 1 << 3
    assert int(level1["full"]) == 0


@pytest.mark.parametrize("row_map", [False, True])
def test_level_reference_counts_pairs(row_map):
    """The counter adds the (in-neighbour, segment) pairs the masks list
    and those of them whose destination segment is full, as a direct
    count gives them; level 1 skips none."""
    width = 70                              # 3 segments
    ft, mask, nb, vis = _level_case(width, 9, 13, seed=3)
    full = kernels.full_masks(vis)
    got = _run_level(ft, mask, nb, vis, full, pairs=True, row_map=row_map)
    masks = mask.numpy().view(np.uint32)
    fulls = full.numpy().view(np.uint32)
    listed = skipped = 0
    for m, row in enumerate(nb.numpy()):
        for src in row:
            listed += bin(int(masks[src])).count("1")
            skipped += bin(int(masks[src]) & int(fulls[m])).count("1")
    assert skipped > 0
    want = [listed, 0 if row_map else skipped]
    assert got["pairs"].tolist() == want


def test_level_wrapper_on_cpu_runs_plain_version_without_launch():
    f, ft = sparse_frontier(30, 7, seed=1)
    mask = as_int32(masks_by_hand(f))
    nb = torch.from_numpy(in_neighbours(30, 12, kernels.LEVEL_CHUNK + 3,
                                        seed=2))         # a split bucket
    outs = [torch.zeros((12, 7), dtype=torch.int32),
            torch.zeros((12, 7), dtype=torch.int32),
            torch.zeros(12, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int64)]
    want = [t.clone() for t in outs]
    before = kernels.bucket_or_level.launches
    kernels.bucket_or_level(ft, mask, nb, *outs)
    assert kernels.bucket_or_level.launches == before
    kernels.bucket_or_level_reference(ft, mask, nb, *want)
    for g, w in zip(outs, want):
        assert torch.equal(g, w)
    assert int(outs[3]) > 0


@pytest.mark.parametrize("degree", [1, 255, 256, 257, 3_000])
def test_level_wrapper_split_rows_match_unsplit_plain(degree):
    """Around the chunk (256 in-neighbours a warp) the CPU route gives the
    plain version's answer, whatever the split."""
    f, ft = sparse_frontier(40, 9, seed=degree)
    f[5] = 0xFFFFFFFF                        # a dense in-neighbour
    ft = torch.from_numpy(f.view(np.int32).copy())
    mask = as_int32(masks_by_hand(f))
    nb = torch.from_numpy(in_neighbours(40, 3, degree, seed=degree + 1))
    outs = [torch.zeros((3, 9), dtype=torch.int32) for _ in range(2)] + \
        [torch.zeros(3, dtype=torch.int32),
         torch.zeros(1, dtype=torch.int64)]
    kernels.bucket_or_level(ft, mask, nb, *outs)
    reach = kernels.bucket_or_reference(ft, nb).numpy().view(np.uint32)
    np.testing.assert_array_equal(outs[0].numpy().view(np.uint32), reach)
    assert int(outs[3]) == int(np.unpackbits(reach.view(np.uint8)).sum())


def _bad_level_inputs(case):
    a = dict(f=torch.zeros((10, 4), dtype=torch.int32),
             mask=torch.zeros(10, dtype=torch.int32),
             in_nb=torch.zeros((3, 2), dtype=torch.int32),
             frontier=torch.zeros((3, 4), dtype=torch.int32),
             visited=torch.zeros((3, 4), dtype=torch.int32),
             out_mask=torch.zeros(3, dtype=torch.int32),
             total=torch.zeros(1, dtype=torch.int64))
    kw = {}
    if case == "f_dtype":
        a["f"] = a["f"].to(torch.int64)
    elif case == "mask_shape":
        a["mask"] = a["mask"][:9]
    elif case == "out_shape":
        a["frontier"] = torch.zeros((3, 5), dtype=torch.int32)
    elif case == "out_mask_shape":
        a["out_mask"] = torch.zeros(4, dtype=torch.int32)
    elif case == "total_dtype":
        a["total"] = torch.zeros(1, dtype=torch.int32)
    elif case == "total_size":
        a["total"] = torch.zeros(2, dtype=torch.int64)
    elif case == "strided":
        a["visited"] = torch.zeros((3, 8), dtype=torch.int32)[:, ::2]
    elif case == "seeds_without_mask":
        kw = dict(seeds=torch.zeros((3, 4), dtype=torch.int32))
    elif case == "seeds_shape":
        kw = dict(seeds=torch.zeros((2, 4), dtype=torch.int32),
                  seeds_mask=torch.zeros(2, dtype=torch.int32),
                  rows=torch.arange(3, dtype=torch.int32))
    elif case == "rows_shape":
        kw = dict(seeds=torch.zeros((3, 4), dtype=torch.int32),
                  seeds_mask=torch.zeros(3, dtype=torch.int32),
                  rows=torch.zeros(2, dtype=torch.int32))
    elif case == "rows_without_seeds":
        kw = dict(rows=torch.arange(3, dtype=torch.int32))
    elif case == "device":
        a = {k: v.to("meta") for k, v in a.items()}
    elif case == "mixed_devices":
        a["in_nb"] = a["in_nb"].to("meta")
    elif case == "full_dtype":
        kw = dict(full=torch.zeros(3, dtype=torch.int64))
    elif case == "full_shape":
        kw = dict(full=torch.zeros(4, dtype=torch.int32))
    elif case == "full_device":
        kw = dict(full=torch.zeros(3, dtype=torch.int32, device="meta"))
    elif case == "full_strided":
        kw = dict(full=torch.zeros(6, dtype=torch.int32)[::2])
    elif case == "pairs_dtype":
        kw = dict(pairs=torch.zeros(2, dtype=torch.int32))
    elif case == "pairs_shape":
        kw = dict(pairs=torch.zeros(3, dtype=torch.int64))
    elif case == "pairs_device":
        kw = dict(pairs=torch.zeros(2, dtype=torch.int64, device="meta"))
    return a, kw


@pytest.mark.parametrize("case", [
    "f_dtype", "mask_shape", "out_shape", "out_mask_shape", "total_dtype",
    "total_size", "strided", "seeds_without_mask", "seeds_shape",
    "rows_shape", "rows_without_seeds", "device", "mixed_devices",
    "full_dtype", "full_shape", "full_device", "full_strided",
    "pairs_dtype", "pairs_shape", "pairs_device"])
def test_level_wrapper_rejects(case):
    a, kw = _bad_level_inputs(case)
    with pytest.raises((TypeError, ValueError)):
        kernels.bucket_or_level(*a.values(), **kw)


def test_level_source_builds_beside_bucket_or():
    """Both entry points are in one source, and the kernel's chunk and
    row limit are the wrapper's (the launcher refuses another chunk)."""
    src = (_build.CSRC_DIR / "bucket_or.cu").read_text()
    for entry in ("bucket_or_launch", "bucket_or_level_launch"):
        assert f'extern "C" int {entry}(' in src
    batches = int(re.search(r"constexpr int kBatches = (\d+);", src)[1])
    assert "constexpr int64_t kChunk = 32 * kBatches;" in src
    assert 32 * batches == kernels.LEVEL_CHUNK
    assert "kMaxRows = int64_t(1) << 27;" in src
    assert kernels.LEVEL_MAX_ROWS == 1 << 27


def test_level_wrapper_rejects_too_many_rows():
    def meta(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    rows = kernels.LEVEL_MAX_ROWS + 1
    with pytest.raises(ValueError, match="at most"):
        kernels.bucket_or_level(meta(rows, 1), meta(rows), meta(3, 2),
                                meta(3, 1), meta(3, 1), meta(3),
                                meta(1, dtype=torch.int64))


# -- score_dot and score_int8 (csrc/score.cu) ---------------------------------


def reorder_bound(q, rows):
    """d * 2^-24 * sum_k |q_k c_k|: the most two float32 dot products of
    depth d that sum the same products in other orders can differ by
    (here float64, element by element)."""
    q64, c64 = np.abs(np.asarray(q, np.float64)), np.abs(
        np.asarray(rows, np.float64))
    return q.shape[1] * 2.0 ** -24 * (q64 @ c64.T)


def test_score_dot_reference_matches_pallas_interpret():
    """As tests/test_knn.py's Pallas parity case: 2,048 x 64, b = 4."""
    from dgraph_tpu.ops.pallas_kernels import score_dot_pallas

    rng = np.random.default_rng(6)
    corpus = rng.standard_normal((2048, 64), dtype=np.float32)
    q = rng.standard_normal((4, 64), dtype=np.float32)
    got = kernels.score_dot_reference(torch.from_numpy(corpus),
                                      torch.from_numpy(q)).numpy()
    bound = reorder_bound(q, corpus)
    for want in (np.asarray(score_dot_pallas(jnp.asarray(corpus),
                                             jnp.asarray(q),
                                             interpret=True)),
                 np.asarray(jnp.dot(jnp.asarray(q), jnp.asarray(corpus).T))):
        assert got.shape == want.shape == (4, 2048)
        assert (np.abs(got.astype(np.float64) - want) <= bound).all()


def test_score_int8_reference_matches_pallas_interpret():
    """As tests/test_knn.py's IVF case: an index's first 512 code rows."""
    from dgraph_tpu.ops import ivf
    from dgraph_tpu.ops.pallas_kernels import score_int8_pallas, score_int8_xla

    rng = np.random.default_rng(33)
    centers = rng.standard_normal((32, 64)).astype(np.float32)
    corpus = centers[rng.integers(0, 32, 4096)] + np.float32(0.3) * \
        rng.standard_normal((4096, 64)).astype(np.float32)
    ix = ivf.build(corpus, seed=0, calibrate=False)
    codes = np.asarray(ix.codes[:512], np.int8)
    q = corpus[:3] + np.float32(0.01)
    got = kernels.score_int8_reference(torch.from_numpy(codes),
                                       torch.from_numpy(q)).numpy()
    bound = reorder_bound(q, codes)
    for want in (np.asarray(score_int8_pallas(jnp.asarray(codes),
                                              jnp.asarray(q),
                                              interpret=True)),
                 np.asarray(score_int8_xla(jnp.asarray(codes),
                                           jnp.asarray(q)))):
        assert got.shape == want.shape == (3, 512)
        assert (np.abs(got.astype(np.float64) - want) <= bound).all()


@pytest.mark.parametrize("name", ["score_dot", "score_int8"])
@pytest.mark.parametrize("n,b,d", [(1, 1, 16), (777, 3, 100), (130, 5, 7)])
def test_score_wrapper_on_cpu_runs_plain_version_without_launch(name, n, b,
                                                                d):
    rng = np.random.default_rng(n + b + d)
    if name == "score_dot":
        rows = torch.from_numpy(rng.standard_normal((n, d), np.float32))
    else:
        rows = torch.from_numpy(rng.integers(-127, 128, (n, d), np.int8))
    q = torch.from_numpy(rng.standard_normal((b, d), np.float32))
    wrapper = getattr(kernels, name)
    plain = getattr(kernels, f"{name}_reference")
    before = kernels.launch_counts()
    got = wrapper(rows, q)
    assert kernels.launch_counts() == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, n)
    assert torch.equal(got, plain(rows, q))
    # out=: a [b, n] view of a flat buffer, neighbours kept
    big = torch.full((b * n + 2,), 7.0)
    res = wrapper(rows, q, out=big[1:b * n + 1].view(b, n))
    assert res.data_ptr() == big[1:].data_ptr()
    assert torch.equal(res, got)
    assert float(big[0]) == 7.0 and float(big[-1]) == 7.0


def _bad_score_inputs(name, case):
    dtype = torch.float32 if name == "score_dot" else torch.int8
    rows = torch.zeros((10, 4), dtype=dtype)
    q = torch.zeros((3, 4), dtype=torch.float32)
    out = None
    if case == "rows_dtype":
        rows = rows.to(torch.float64 if name == "score_dot" else torch.int16)
    elif case == "q_dtype":
        q = q.to(torch.float64)
    elif case == "rank":
        rows = rows.reshape(-1)
    elif case == "depth":
        q = torch.zeros((3, 5), dtype=torch.float32)
    elif case == "non_contiguous":
        rows = torch.zeros((4, 10), dtype=dtype).t()
    elif case == "out_shape":
        out = torch.zeros((3, 11))
    elif case == "out_dtype":
        out = torch.zeros((3, 10), dtype=torch.float64)
    elif case == "out_strided":
        out = torch.zeros((3, 20))[:, ::2]
    elif case == "device":
        rows, q = rows.to("meta"), q.to("meta")
    elif case == "mixed_devices":
        q = q.to("meta")
    return rows, q, out


@pytest.mark.parametrize("name", ["score_dot", "score_int8"])
@pytest.mark.parametrize("case", [
    "rows_dtype", "q_dtype", "rank", "depth", "non_contiguous", "out_shape",
    "out_dtype", "out_strided", "device", "mixed_devices"])
def test_score_wrapper_rejects(name, case):
    rows, q, out = _bad_score_inputs(name, case)
    with pytest.raises((TypeError, ValueError)):
        getattr(kernels, name)(rows, q, out=out)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
def test_score_metric_on_cpu_runs_plain_version_without_launch(metric):
    """On CPU tensors score_metric runs its plain version and counts no
    launch: the plain dots and `knn._epilogue`, each live column the mask
    keeps holding its score and every other column -inf, as the device
    top-k composed them before the kernel's store took them."""
    rng = np.random.default_rng(24)
    n, b, d, n_live, n_out = 130, 3, 7, 120, 256
    rows = torch.from_numpy(rng.standard_normal((n, d), np.float32))
    rows[5] = 0
    q = torch.from_numpy(rng.standard_normal((b, d), np.float32))
    keep = torch.from_numpy(rng.random(n_live) > 0.3)
    scores = tknn._epilogue(kernels.score_dot_reference(rows, q), rows, q,
                            metric)
    before = kernels.launch_counts()
    for mask in (None, keep):
        got = kernels.score_metric(rows, q, metric, n_live, n_out, mask)
        live = torch.arange(n_live) if mask is None else \
            torch.nonzero(mask)[:, 0]
        want = torch.full((b, n_out), -math.inf)
        want[:, live] = scores[:, live]
        assert torch.equal(got, want)
        assert torch.equal(got, kernels.score_metric_reference(
            rows, q, metric, n_live, n_out, mask))
        # out=: a [b, n_out] view of a flat buffer, neighbours kept
        big = torch.full((b * n_out + 2,), 7.0)
        res = kernels.score_metric(rows, q, metric, n_live, n_out, mask,
                                   out=big[1:-1].view(b, n_out))
        assert res.data_ptr() == big[1:].data_ptr()
        assert torch.equal(res, got)
        assert float(big[0]) == 7.0 and float(big[-1]) == 7.0
    assert kernels.launch_counts() == before
    # flat, an int a name: the stats op's kernelLaunches, one a metric
    assert {k for k in before if k.startswith("score_metric.")} == {
        "score_metric.cosine", "score_metric.dot", "score_metric.euclidean"}
    assert all(type(v) is int for v in before.values())


@pytest.mark.parametrize("case", [
    "dtype", "shape", "device", "metric", "mask_length", "mask_dtype",
    "n_live", "n_out"])
def test_score_metric_rejects(case):
    rows = torch.zeros((10, 4))
    q = torch.zeros((3, 4))
    metric, n_live, n_out, mask = "cosine", 10, 16, None
    if case == "dtype":
        q = q.to(torch.float64)
    elif case == "shape":
        q = torch.zeros((3, 5))
    elif case == "device":
        rows, q = rows.to("meta"), q.to("meta")
    elif case == "metric":
        metric = "manhattan"
    elif case == "mask_length":
        mask = torch.ones(9, dtype=torch.bool)
    elif case == "mask_dtype":
        mask = torch.ones(10, dtype=torch.uint8)
    elif case == "n_live":                 # past the rows and n_out
        n_live = 17
    elif case == "n_out":                  # fewer columns than rows,
        n_out = 9                          # and out= narrower than n_out
        out = torch.zeros((3, 15))
        with pytest.raises(ValueError):
            kernels.score_metric(rows, q, metric, n_live, 16, mask, out=out)
    with pytest.raises((TypeError, ValueError)):
        kernels.score_metric(rows, q, metric, n_live, n_out, mask)


def test_score_source_builds_beside_bucket_or():
    """csrc/score.cu holds the dense float32 product (two routes, the
    tile and the row kernel, behind one C entry point) and the int8
    list-table product; the old template that served both element types
    is gone."""
    assert (_build.CSRC_DIR / "score.cu").exists()
    assert _build.library_path("score").parent == _build.BUILD_DIR
    src = (_build.CSRC_DIR / "score.cu").read_text()
    for entry in ("score_dot_launch", "score_int8_lists_launch",
                  "score_int8_lists_limits"):
        assert f'extern "C" int {entry}(' in src
    assert 'extern "C" int score_int8_launch(' not in src
    assert "score_kernel<" not in src
    assert "__fmul_rn" in src and "__fadd_rn" in src
    assert "cp.async" in src
    assert "score_dot_kernel(" in src and "score_dot_rows_kernel(" in src
    # the store's epilogues and the tile route's depth segment, as the
    # wrapper passes and cuts them
    epi = ", ".join(f"EPI_{m.upper()} = {v}" for m, v in
                    sorted(kernels.EPILOGUES.items(), key=lambda e: e[1]))
    assert f"constexpr int {epi};" in src
    assert f"static_assert(C::DSEG == {kernels.DOT_TILE_DSEG}," in src
    assert "__fmaf_rn" in src and "__fdiv_rn" in src and "__fsqrt_rn" in src


# -- score_dot's routes: the plan and the row route's walk -------------------

CROSS = kernels.DOT_ROWS_MAX_B
# rows a lane of the row route scores at once, by queries a pass
# (RowTile in csrc/score.cu: change both together)
ROW_R = {1: 4, 2: 4, 4: 2, 8: 2, 16: 1, 32: 1}


def test_row_tiles_match_the_source():
    src = (_build.CSRC_DIR / "score.cu").read_text()
    assert "static constexpr int R = QT <= 2 ? 4 : QT <= 8 ? 2 : 1;" in src
    assert "constexpr int ROW_QFLOATS = 8192;" in src
    assert kernels.DOT_ROW_QFLOATS == 8192
    assert sorted(kernels.DOT_ROW_LANES) == sorted(ROW_R)
    for q_tile in ROW_R:
        assert f"case {q_tile}: return launch_rows<{q_tile}, VEC, NORMS>" \
            in src


@pytest.mark.parametrize("d", [16, 37, 100, 128, 1024])
def test_score_dot_plan_routes_by_batch_and_alignment(d):
    """The row route up to the crossover, in the smallest query tile that
    holds the batch (passes of 32 above 32), lanes no wider than a depth
    segment's loads; the tile route past the crossover; 16-byte loads
    only for d % 4 == 0 on a 16-byte corpus."""
    for align in (4, 8, 16):
        vec = 4 if d % 4 == 0 and align == 16 else 1
        for b in (1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, CROSS - 1, CROSS):
            plan = kernels.score_dot_plan(b, d, align)
            q_tile = min(t for t in ROW_R if t >= min(b, 32))
            seg = min(d, kernels.DOT_ROW_QFLOATS // q_tile)
            loads = -(-seg // vec)
            lanes = min(kernels.DOT_ROW_LANES[q_tile],
                        1 << (loads - 1).bit_length())
            assert plan == kernels.DotPlan(kernels.DOT_ROWS, vec, q_tile,
                                           lanes), (b, align)
            assert 1 <= plan.lanes <= 32 and plan.lanes & (plan.lanes - 1) == 0
        for b in (CROSS + 1, 64, 256, 257, 100_000):
            assert kernels.score_dot_plan(b, d, align) == kernels.DotPlan(
                kernels.DOT_TILE, vec, kernels.DOT_TILE_Q, 1)


def test_score_dot_plan_rejects():
    for args in ((0, 128, 16), (1, 0, 16), (-1, 4, 16), (1, 128, 3),
                 (1, 128, 32), (1, 128, 0)):
        with pytest.raises(ValueError):
            kernels.score_dot_plan(*args)


def row_route_cover(plan, n, b, d, n_out=None):
    """score_dot_rows_kernel's walk over a call, written out from the CUDA
    source: (how often each (query, row, depth) product is summed into a
    lane's partial sum, how often each of the n_out (default n) scores is
    stored, how often a store adds to the output). The grid-stride loop
    hands every unit to one warp whatever the grid, so the walk takes the
    units in turn; units cover the n_out columns, rows past n load
    zeros."""
    n_out = n if n_out is None else n_out
    r_rows, w = ROW_R[plan.q_tile], plan.vec
    groups = 32 // plan.lanes
    unit = groups * r_rows
    span = plan.lanes * w
    dseg = kernels.DOT_ROW_QFLOATS // plan.q_tile
    summed = np.zeros((b, n, d), np.int64)
    stored = np.zeros((b, n_out), np.int64)
    added = np.zeros((b, n_out), np.int64)
    lane = np.arange(32)
    sub, grp = lane % plan.lanes, lane // plan.lanes
    for q0 in range(0, b, plan.q_tile):
        bq = min(plan.q_tile, b - q0)
        for k0 in range(0, d, dseg):
            ds = min(dseg, d - k0)
            for u in range(-(-n_out // unit)):
                for t in range(-(-ds // span)):
                    k = sub * w + t * span
                    for r in range(r_rows):
                        row = u * unit + grp + r * groups
                        ok = (row < n) & (k < ds)
                        for i in range(w):
                            summed[q0:q0 + bq, row[ok], k0 + k[ok] + i] += 1
                for r in range(r_rows):
                    for j in range(bq):
                        mine = (sub == (r * plan.q_tile + j) % plan.lanes)
                        row = (u * unit + grp + r * groups)[mine]
                        row = row[row < n_out]
                        stored[q0 + j, row] += 1
                        added[q0 + j, row] += k0 > 0
    return summed, stored, added


@pytest.mark.parametrize("n,b,d,align", [
    (777, 3, 37, 16), (1, 1, 16, 16), (130, 1, 128, 16), (70, 33, 1024, 16),
    (50, 17, 100, 4), (9, CROSS, 24, 16)])
def test_row_route_sums_every_product_once(n, b, d, align):
    """Every product of the row route's plan summed exactly once, every
    score stored once a depth segment, the later segments adding: the
    kernel's sum is the plain version's products in another order. So
    too with the output wider than the corpus (score_metric's padding
    columns, which are stored but sum no product)."""
    plan = kernels.score_dot_plan(b, d, align)
    assert plan.route == kernels.DOT_ROWS
    segments = -(-d // kernels.dot_segment(plan))
    assert segments == -(-d // (kernels.DOT_ROW_QFLOATS // plan.q_tile))
    for n_out in (n, n + 70):
        summed, stored, added = row_route_cover(plan, n, b, d, n_out)
        assert (summed == 1).all()
        assert (stored == segments).all()
        assert (added == segments - 1).all()


@pytest.mark.parametrize("b", [1, 2, CROSS, CROSS + 1])
def test_score_dot_reference_matches_pallas_interpret_by_route(b):
    """The plain version against score_dot_pallas in interpret mode at
    the batches on either side of the crossover, within the reordering
    bound; the wrapper on CPU tensors runs it with no launch, whatever
    plan it is handed."""
    from dgraph_tpu.ops.pallas_kernels import score_dot_pallas

    rng = np.random.default_rng(1500 + b)
    corpus = rng.standard_normal((1024, 48), dtype=np.float32)
    q = rng.standard_normal((b, 48), dtype=np.float32)
    plan = kernels.score_dot_plan(b, 48, 16)
    assert plan.route == (kernels.DOT_ROWS if b <= CROSS
                          else kernels.DOT_TILE)
    ct, qt = torch.from_numpy(corpus), torch.from_numpy(q)
    before = kernels.launch_counts()
    got = kernels.score_dot(ct, qt, plan=plan)
    assert kernels.launch_counts() == before
    assert torch.equal(got, kernels.score_dot_reference(ct, qt))
    want = np.asarray(score_dot_pallas(jnp.asarray(corpus), jnp.asarray(q),
                                       interpret=True))
    assert want.shape == (b, 1024)
    assert (np.abs(got.numpy().astype(np.float64) - want)
            <= reorder_bound(q, corpus)).all()


# -- score_int8_lists: the work table and the plain version ------------------


def _slot_offsets(table, m_tile):
    """query slot -> (list start, output offset of its row of scores),
    from a table, checking each entry's chunk against m_tile."""
    got = {}
    for s, ln, a, m, off in table.tolist():
        assert 1 <= m <= m_tile and ln >= 1
        for j in range(m):
            assert a + j not in got
            got[a + j] = (s, off + j * ln)
    return got


@pytest.mark.parametrize("m_tile", [1, 2, 8, None])
@pytest.mark.parametrize("ms", [(1,), (8,), (9,), (17, 2, 1),
                                (0, 5, 8, 9)])
def test_int8_lists_table_layout(m_tile, ms):
    """Every (list, query) pair once, chunks of at most m_tile (None:
    one entry a list), lists with no rows or no queries skipped, and
    each query's row of scores at the offset the per-list loop gave it:
    lists one after another, m * rows floats each, query after query."""
    rng = np.random.default_rng(sum(ms) + (m_tile or 0))
    starts = np.cumsum([0] + [int(rng.integers(0, 9)) for _ in ms]
                       + [0])           # some lists have no rows
    slices = [(int(starts[i]), int(starts[i + 1]),
               sorted(rng.choice(40, m, replace=False).tolist()))
              for i, m in enumerate(ms)]
    table, qidx, total = kernels.int8_lists_table(slices, m_tile)
    assert table.dtype == np.int64 and table.shape[1] == 5
    got = _slot_offsets(table, m_tile or max(ms))
    assert sorted(got) == list(range(len(qidx)))
    step = m_tile or max(ms)
    assert len(table) == sum(-(-len(qis) // step)
                             for s, e, qis in slices if e > s)
    want_pairs, want_off, off = [], [], 0
    for s, e, qis in slices:
        if e <= s or not qis:
            continue
        for j, qi in enumerate(qis):
            want_pairs.append((s, qi))
            want_off.append(off + j * (e - s))
        off += len(qis) * (e - s)
    assert total == off
    assert [(got[i][0], int(qidx[i])) for i in range(len(qidx))] == \
        want_pairs
    assert [got[i][1] for i in range(len(qidx))] == want_off


def test_int8_lists_table_empty():
    table, qidx, total = kernels.int8_lists_table([(3, 3, [1]), (4, 9, [])])
    assert table.shape == (0, 5) and qidx.shape == (0,) and total == 0


def test_lists_m_tile_fits_shared_memory(monkeypatch):
    """Only the kernel keeps an entry's queries in shared memory, and
    its library states how many fit (`score_int8_lists_limits`, read on
    the card); the CPU's plain version has no such limit, so a table
    built for it holds each list in one entry, and asking needs no
    library."""
    def no_library():
        raise AssertionError("the CPU route loaded the kernel's library")

    monkeypatch.setattr(kernels, "load_score_library", no_library)
    for d in (1, 128, 5790, 40_000):
        assert kernels.lists_m_tile(d, torch.device("cpu")) is None
        assert kernels.lists_m_tile(d, "cpu") is None
    table, _, _ = kernels.int8_lists_table(
        [(0, 5, list(range(40))), (5, 9, [3])],
        kernels.lists_m_tile(128, "cpu"))
    np.testing.assert_array_equal(table[:, 3], [40, 1])
    src = (_build.CSRC_DIR / "score.cu").read_text()
    assert 'extern "C" int score_int8_lists_limits(' in src


@pytest.mark.parametrize("with_slots", [False, True])
def test_lists_meta_maps_every_row_tile(with_slots):
    """The buffer the list kernel reads: each entry's first row tile,
    each row tile's entry (the kernel's two loads that find its work),
    the slots' queries and their terms, at the offsets it is given."""
    table = np.array([[0, 1, 0, 1, 0], [5, 0, 1, 2, 1], [9, 300, 1, 2, 1],
                      [400, 128, 3, 1, 601], [600, 129, 4, 3, 729]],
                     np.int64)
    qidx = np.array([4, 0, 2, 9, 1, 1, 3], np.int64) if with_slots else None
    cterm = np.linspace(-2, 2, 7, dtype=np.float32) if with_slots else None
    rows = 64
    meta, n_tiles, (at_t, at_q, at_c) = kernels.lists_meta(table, qidx,
                                                           cterm, rows)
    assert n_tiles == 1 + 0 + 5 + 2 + 3
    full = meta[:at_t].reshape(-1, 6)
    np.testing.assert_array_equal(full[:, :5], table)
    np.testing.assert_array_equal(full[:, 5], [0, 1, 1, 6, 8])
    entry = meta[at_t:at_q].view(np.int32)[:n_tiles]
    np.testing.assert_array_equal(entry, [0, 2, 2, 2, 2, 2, 3, 3, 4, 4, 4])
    # block t scores rows [(t - first) * 64, ...) of its entry: every
    # row of every entry exactly once
    seen = [(int(full[e, 0]) + (t - int(full[e, 5])) * rows + r)
            for t, e in enumerate(entry) for r in range(rows)
            if (t - full[e, 5]) * rows + r < full[e, 1]]
    want = [int(s) + r for s, ln, *_ in table.tolist() for r in range(ln)]
    assert sorted(seen) == sorted(want)
    if with_slots:
        np.testing.assert_array_equal(meta[at_q:at_c], qidx)
        np.testing.assert_array_equal(meta[at_c:].view(np.float32)[:7], cterm)
    else:
        assert len(meta) == at_q == at_c


def _lists_case(seed, d=64, n=3000, b=40):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (n, d), dtype=np.int8)
    q = rng.standard_normal((b, d), dtype=np.float32)
    scales = (rng.random(n, dtype=np.float32) / 127).astype(np.float32)
    slices = [(0, 1, [3]), (1, 700, [0, 5]), (700, 700, [2]),
              (700, 1500, list(range(17))), (1500, 2999, [39]),
              (2999, 3000, list(range(0, 40, 2)))]
    return codes, q, scales, slices


def test_score_int8_lists_reference_matches_pallas_interpret():
    """Entry by entry, the plain version's dots (no scales, no terms)
    against the TPU kernel in interpret mode and `score_int8_xla` within
    the reordering bound; with scales and terms it is exactly
    fl(fl(dot * scale) + term), the reference's `dots * scales + cent`."""
    from dgraph_tpu.ops.pallas_kernels import (
        SCORE_TILE_N, score_int8_pallas, score_int8_xla)

    codes, q, scales, slices = _lists_case(41)
    table, qidx, total = kernels.int8_lists_table(slices)
    ct, qt = torch.from_numpy(codes), torch.from_numpy(q)
    dots = kernels.score_int8_lists_reference(
        ct, qt, table, torch.full((total,), np.nan), qidx=qidx).numpy()
    cterm = np.random.default_rng(42).standard_normal(
        len(qidx)).astype(np.float32)
    full = kernels.score_int8_lists_reference(
        ct, qt, table, torch.full((total,), np.nan), qidx=qidx,
        scales=torch.from_numpy(scales), cterm=cterm).numpy()
    assert not np.isnan(dots).any() and not np.isnan(full).any()
    for s, ln, a, m, off in table.tolist():
        block = codes[s:s + ln]
        qs = q[qidx[a:a + m]]
        got = dots[off:off + m * ln].reshape(m, ln)
        pad = np.zeros((-ln % SCORE_TILE_N, codes.shape[1]), np.int8)
        padded = jnp.asarray(np.concatenate([block, pad]))
        bound = reorder_bound(qs, block)
        for want in (np.asarray(score_int8_pallas(padded, jnp.asarray(qs),
                                                  interpret=True))[:, :ln],
                     np.asarray(score_int8_xla(jnp.asarray(block),
                                               jnp.asarray(qs)))):
            assert (np.abs(got.astype(np.float64) - want) <= bound).all()
        epi = got * scales[s:s + ln][None, :] + cterm[a:a + m, None]
        assert epi.dtype == np.float32
        np.testing.assert_array_equal(full[off:off + m * ln].reshape(m, ln),
                                      epi)


def test_score_int8_lists_wrapper_on_cpu_runs_plain_version_without_launch():
    codes, q, scales, slices = _lists_case(43, d=37)
    table, qidx, total = kernels.int8_lists_table(slices)
    cterm = np.linspace(-1, 1, len(qidx), dtype=np.float32)
    args = (torch.from_numpy(codes), torch.from_numpy(q), table)
    kw = dict(qidx=qidx, scales=torch.from_numpy(scales), cterm=cterm)
    before = kernels.score_int8.launches
    big = torch.full((total + 2,), 7.0)
    res = kernels.score_int8_lists(*args, big[1:total + 1], **kw)
    assert kernels.score_int8.launches == before
    assert res.data_ptr() == big[1:].data_ptr()
    want = kernels.score_int8_lists_reference(*args, torch.empty(total),
                                              **kw)
    assert torch.equal(res, want)
    assert float(big[0]) == 7.0 and float(big[-1]) == 7.0
    # an empty table writes nothing
    empty = np.zeros((0, 5), np.int64)
    out = torch.full((4,), 7.0)
    kernels.score_int8_lists(args[0], args[1], empty, out)
    assert kernels.score_int8.launches == before
    assert bool((out == 7.0).all())


def _bad_lists_inputs(case):
    codes = torch.zeros((10, 4), dtype=torch.int8)
    q = torch.zeros((3, 4), dtype=torch.float32)
    table = np.array([[0, 10, 0, 3, 0]], np.int64)
    out = torch.zeros(30)
    kw = {}
    if case == "codes_dtype":
        codes = codes.to(torch.int16)
    elif case == "depth":
        q = torch.zeros((3, 5))
    elif case == "out_rank":
        out = out.view(3, 10)
    elif case == "out_dtype":
        out = out.double()
    elif case == "out_short":
        out = torch.zeros(29)
    elif case == "table_dtype":
        table = table.astype(np.int32)
    elif case == "table_shape":
        table = table[:, :4]
    elif case == "table_tensor":
        table = torch.from_numpy(table)
    elif case == "rows_past_end":
        table = np.array([[5, 6, 0, 3, 0]], np.int64)
    elif case == "too_many_queries":     # more than there are slots
        table = np.array([[0, 1, 0, 17, 0]], np.int64)
    elif case == "no_queries":
        table = np.array([[0, 10, 0, 0, 0]], np.int64)
    elif case == "slots_past_end":
        table = np.array([[0, 10, 1, 3, 0]], np.int64)
    elif case == "qidx_range":
        kw["qidx"] = np.array([0, 1, 3], np.int64)
    elif case == "cterm_length":
        kw["cterm"] = np.zeros(2, np.float32)
    elif case == "scales_shape":
        kw["scales"] = torch.ones(9)
    elif case == "device":
        codes, q, out = codes.to("meta"), q.to("meta"), out.to("meta")
    return codes, q, table, out, kw


@pytest.mark.parametrize("case", [
    "codes_dtype", "depth", "out_rank", "out_dtype", "out_short",
    "table_dtype", "table_shape", "table_tensor", "rows_past_end",
    "too_many_queries", "no_queries", "slots_past_end", "qidx_range",
    "cterm_length", "scales_shape", "device"])
def test_score_int8_lists_wrapper_rejects(case):
    codes, q, table, out, kw = _bad_lists_inputs(case)
    with pytest.raises((TypeError, ValueError)):
        kernels.score_int8_lists(codes, q, table, out, **kw)


def test_build_all_failure_raises_and_leaves_nothing(monkeypatch, tmp_path):
    """One nvcc per source, started together; any failure raises."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_all(["bucket_or", "score"])
    assert not list(tmp_path.glob("*.so"))


# -- bitmap_and (csrc/bitmap_and.cu) ------------------------------------------


def bitmap_words(k, b, seed, w=1024):
    """k random uint64 word matrices [k, b, w] and the same bits as an
    int64 tensor."""
    rng = np.random.default_rng(seed)
    mats = rng.integers(0, 2**64, (k, b, w), dtype=np.uint64)
    return mats, torch.from_numpy(mats.view(np.int64).copy())


@pytest.mark.parametrize("k", [2, 3, 4, 8])
@pytest.mark.parametrize("b", [1, 7, 8, 9])
def test_bitmap_and_reference_matches_pallas_interpret(k, b):
    """The k-way AND against the TPU kernel folded pairwise over the
    uint32 lanes, as the reference's bitmap_and_device does, and against
    numpy's &."""
    from dgraph_tpu.ops.pallas_kernels import bitmap_and_pallas

    mats, mt = bitmap_words(k, b, seed=k * 100 + b)
    got = kernels.bitmap_and_reference(mt)
    assert got.dtype == torch.int64 and tuple(got.shape) == (b, 1024)
    acc = mats[0].view(np.uint32)
    for m in mats[1:]:
        acc = np.asarray(bitmap_and_pallas(jnp.asarray(acc),
                                           jnp.asarray(m.view(np.uint32)),
                                           interpret=True))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  acc.view(np.uint64))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.bitwise_and.reduce(mats, axis=0))


@pytest.mark.parametrize("k,b,w", [(1, 3, 1024), (2, 5, 5), (5, 1, 1024),
                                   (3, 4096, 1024)])
def test_bitmap_and_wrapper_on_cpu_runs_plain_version_without_launch(k, b, w):
    mats, mt = bitmap_words(k, b, seed=k + b + w, w=w)
    before = kernels.bitmap_and.launches
    got = kernels.bitmap_and(mt)
    assert kernels.bitmap_and.launches == before
    assert torch.equal(got, kernels.bitmap_and_reference(mt))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.bitwise_and.reduce(mats, axis=0))
    # the plain version leaves its inputs as they were
    np.testing.assert_array_equal(mt.numpy().view(np.uint64), mats)


@pytest.mark.parametrize("case", ["dtype", "rank", "empty_k",
                                  "non_contiguous", "device"])
def test_bitmap_and_wrapper_rejects(case):
    mats = torch.zeros((3, 4, 1024), dtype=torch.int64)
    if case == "dtype":
        mats = mats.to(torch.int32)
    elif case == "rank":
        mats = mats[0]
    elif case == "empty_k":
        mats = mats[:0]
    elif case == "non_contiguous":
        mats = torch.zeros((3, 1024, 4), dtype=torch.int64).transpose(1, 2)
    elif case == "device":
        mats = mats.to("meta")
    with pytest.raises((TypeError, ValueError)):
        kernels.bitmap_and(mats)


def test_bitmap_and_source_builds_beside_the_others():
    assert (_build.CSRC_DIR / "bitmap_and.cu").exists()
    assert _build.library_path("bitmap_and").parent == _build.BUILD_DIR
    src = (_build.CSRC_DIR / "bitmap_and.cu").read_text()
    assert 'extern "C" int bitmap_and_launch(' in src


def test_bitmap_and_build_failure_raises(monkeypatch, tmp_path):
    """On a CUDA tensor a failed build raises; nothing falls back to the
    plain version."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.load_bitmap_library()
