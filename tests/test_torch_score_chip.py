"""score_dot's kernel storing a metric's score (`kernels.score_metric`) on
the card: each epilogue against its plain version (the plain dots, the
reference's epilogue, the -inf padding and mask), on both routes, at
depths on and off 16 bytes and past each route's depth segment, with and
without a mask; and the device top-k launching it once a call.

Marked `chip`: each test skips where there is no NVIDIA card. On a card,
from the root of the checkout (the file imports no JAX, so the JAX
package's conftest is left out):

    python -m pytest tests/test_torch_score_chip.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from dgraph_tpu_torch.ops import kernels, knn

pytestmark = pytest.mark.chip

NEG_INF = np.float32(-np.inf).view(np.int32).item()


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, at run
    time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: this host has none")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def case(dev, n, b, d, seed, offset=0):
    """Corpus [n, d] (rows 5 and 17 zero) starting `offset` floats into
    its buffer, and queries [b, d] (query 0 zero when b > 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn(n * d + offset, device=dev, generator=gen)
    corpus = buf[offset:].view(n, d)
    corpus[[5, 17]] = 0
    q = torch.randn((b, d), device=dev, generator=gen)
    if b > 1:
        q[0] = 0
    return corpus, q


# (b, d): the row route's query tiles (1, and 44 in passes of 32) and the
# tile route on either side of the crossover and past one query tile, at
# 128, off 16 bytes (100), past the tile route's depth segment (200) and
# past the row route's (300 at 32 queries a pass, 8,195 at one)
SHAPES = [(b, d) for b in (1, 44, 45, 256, 257) for d in (128, 100, 200)] + \
    [(44, 300), (1, 8195), (45, 300)]


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
def test_score_metric_matches_plain_version(card, metric):
    n, n_out, n_live = 1000, 1064, 990
    launched = 0
    for i, (b, d) in enumerate(SHAPES):
        for offset in ((0, 1) if d == 128 else (0,)):
            corpus, q = case(card, n if d < 1000 else 300, b, d, seed=i,
                             offset=offset)
            rows = corpus.shape[0]
            live = min(n_live, rows)
            for with_mask in (False, True):
                mask = None
                if with_mask:
                    mask = torch.ones(live, dtype=torch.bool, device=card)
                    mask[::3] = False
                plan = kernels.score_dot_plan(
                    b, d, 16 if offset == 0 else 4)
                label = f"b={b} d={d} offset={offset} mask={with_mask} {plan}"
                before = kernels.launch_counts()
                got = kernels.score_metric(corpus, q, metric, live, n_out,
                                           mask)
                torch.cuda.synchronize()
                assert kernels.launch_counts() == {
                    **before, f"score_metric.{metric}":
                    before[f"score_metric.{metric}"] + 1}, label
                launched += 1
                want = kernels.score_metric_reference(corpus, q, metric,
                                                      live, n_out, mask)
                assert got.shape == want.shape == (b, n_out), label
                valid = torch.zeros(n_out, dtype=torch.bool, device=card)
                valid[:live] = True if mask is None else mask
                bits = got.view(torch.int32)
                assert bool((bits[:, ~valid] == NEG_INF).all()), label
                assert torch.equal(got[:, ~valid], want[:, ~valid]), label
                g, w = got[:, valid].double(), want[:, valid].double()
                assert bool(torch.isfinite(g).all()), label
                tol = kernels.score_metric_bound(
                    metric, corpus, q)[:, valid[:rows]]
                ratio = (g - w).abs() / tol.clamp_min(1e-300)
                assert bool((ratio <= 1).all()), \
                    f"{label}: worst {float(ratio.max())} of the tolerance"
                if metric == "cosine":   # zero rows and query score 0
                    zero = torch.zeros(b, rows, dtype=torch.bool,
                                       device=card)
                    zero[:, [5, 17]] = True
                    if b > 1:
                        zero[0] = True
                    z = zero[:, valid[:rows]]
                    assert bool((g[z] == 0).all()), label
    assert launched == sum(4 if d == 128 else 2 for _, d in SHAPES)


def test_score_metric_clears_non_finite_rows(card):
    """A column the call clears holds -inf bit for bit even where its row
    holds NaN or inf (whose score is NaN), for each metric on both
    routes, as the plain version's masked_fill writes it; kept columns
    of finite rows keep finite scores. (One item: the metrics and routes
    loop inside it.)"""
    n, d, n_out = 300, 128, 320
    for metric, b in [(m, b) for m in ("euclidean", "cosine", "dot")
                      for b in (1, 256)]:
        corpus, q = case(card, n, b, d, seed=b)
        corpus[7, 3] = float("nan")
        corpus[9, 0] = float("inf")
        corpus[11] = 3e38                  # its squared norm overflows
        live = 290
        mask = torch.ones(live, dtype=torch.bool, device=card)
        mask[[7, 9, 11]] = False
        corpus[295, 1] = float("nan")      # a dead row past n_live
        got = kernels.score_metric(corpus, q, metric, live, n_out, mask)
        want = kernels.score_metric_reference(corpus, q, metric, live,
                                              n_out, mask)
        torch.cuda.synchronize()
        cleared = torch.ones(n_out, dtype=torch.bool, device=card)
        cleared[:live] = ~mask
        bits = got.view(torch.int32)
        label = f"{metric} b={b}"
        assert bool((bits[:, cleared] == NEG_INF).all()), label
        assert torch.equal(got[:, cleared], want[:, cleared]), label
        assert bool(torch.isfinite(got[:, ~cleared]).all()), label


def test_topk_device_launches_one_fused_kernel(card):
    """One exact device top-k call: one score_metric launch under its
    metric and no other launch counted, and the top-k of the plain
    scores."""
    gen = torch.Generator(device=card).manual_seed(5)
    corpus = torch.randn((5000, 128), device=card, generator=gen)
    q = torch.randn((3, 128), device=card, generator=gen).cpu().numpy()
    mask = np.ones(4990, bool)
    mask[::7] = False

    def call():
        return knn.topk_device(corpus, q, 10, "euclidean", mask=mask,
                               n_real=4990, two_stage=False)

    call()
    before = kernels.launch_counts()
    idx, sc = call()
    assert kernels.launch_counts() == {
        **before, "score_metric.euclidean":
        before["score_metric.euclidean"] + 1}
    assert idx.shape == sc.shape == (3, 10)
    assert np.isfinite(sc).all() and mask[idx].all() and (idx < 4990).all()
    plain = kernels.score_metric_reference(
        corpus, torch.from_numpy(q).to(card), "euclidean", 4990, 5120,
        torch.from_numpy(mask).to(card))
    top = torch.topk(plain, 10, dim=1).indices.cpu().numpy()
    assert (np.sort(idx, axis=1) == np.sort(top, axis=1)).all()
