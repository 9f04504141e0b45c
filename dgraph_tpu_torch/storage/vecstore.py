"""Per-predicate columnar vector store.

The vector analogue of Tablet.value_columns: a float32vector
predicate's embeddings packed into one dense (n, d) float32 block
aligned to a sorted uid row map, built from the tablet's BASE state and
cached per (base_ts, schema) — exactly the contract the device tiles
and columnar views follow (storage/tablet.py value_columns,
engine/device_cache.py).

MVCC overlay semantics match the posting-list reads: the base block
answers every row the overlay does NOT touch at read_ts; overlay-
touched uids (Tablet.overlay_srcs) are masked out of the base block and
re-read through the exact MVCC path (get_postings at read_ts) into a
small side block. ops/knn.py scores base and overlay rows and merges
their top-k, so a mutation is visible at its commit_ts and invisible
below it without ever rebuilding the big block.

Ref: modern Dgraph's vector index attaches to the posting list the same
way (posting/index.go vector index entries); here the "index" IS the
brute-force block, per TPU-KNN (PAPERS.md 2206.14286) — at peak matmul
throughput brute-force beats pointer-chasing structures on this
hardware.

Port of `dgraph_tpu/storage/vecstore.py`. The index trains on the
tablet's device (`ops/ivf.build`: k-means assignment and, on the card,
the calibration's `score_int8_lists` launches) and lives there; its
snapshot payload is the reference's, byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dgraph_tpu_torch.models.types import TypeID, vector_value
from dgraph_tpu_torch.utils import failpoint
from dgraph_tpu_torch.utils.metrics import set_gauge

_EMPTY_U64 = np.empty(0, dtype=np.uint64)


@dataclass
class VecView:
    """One read-timestamp's view of a vector tablet.

    base_uids/base_vecs are the packed BASE block (stable per base_ts —
    safe to keep device-resident); base_keep masks off rows the overlay
    touches at this read_ts. extra_uids/extra_vecs are the overlay-
    visible rows, read through MVCC at read_ts.
    """

    dim: int
    base_uids: np.ndarray       # [n] uint64 sorted
    base_vecs: np.ndarray       # [n, d] float32, C-contiguous
    base_keep: np.ndarray       # [n] bool
    extra_uids: np.ndarray      # [m] uint64 sorted
    extra_vecs: np.ndarray      # [m, d] float32

    @property
    def n_rows(self) -> int:
        return int(self.base_keep.sum()) + len(self.extra_uids)


def _posting_vec(tab, ps) -> np.ndarray | None:
    """First untagged posting's embedding, or None."""
    for p in ps:
        if p.lang:
            continue
        v = p.value
        if v.tid != TypeID.FLOAT32VECTOR:
            v = None
            try:
                from dgraph_tpu_torch.models.types import convert
                v = convert(p.value, TypeID.FLOAT32VECTOR)
            except ValueError:
                return None
        return np.asarray(vector_value(v), np.float32)
    return None


def _base_block(tab) -> tuple[np.ndarray, np.ndarray]:
    """Packed (uids, (n, d) float32) of the tablet's base state, cached
    per (base_ts, schema object) like value_columns. Raises ValueError
    on mixed dimensions — a brute-force block has no meaningful score
    between differently-sized embeddings."""
    cached = getattr(tab, "_vec_base", None)
    if cached is not None and cached[0] == tab.base_ts \
            and cached[1] is tab.schema:
        return cached[2], cached[3]
    uids: list[int] = []
    rows: list[np.ndarray] = []
    dim = None
    for u, ps in tab.values.items():
        vec = _posting_vec(tab, ps)
        if vec is None:
            continue
        if dim is None:
            dim = len(vec)
        elif len(vec) != dim:
            raise ValueError(
                f"predicate {tab.pred!r} holds vectors of differing "
                f"dimension ({dim} vs {len(vec)})")
        uids.append(u)
        rows.append(vec)
    if dim is None:
        uarr = _EMPTY_U64.copy()
        varr = np.empty((0, 0), np.float32)
    else:
        uarr = np.asarray(uids, np.uint64)
        order = np.argsort(uarr, kind="stable")
        uarr = uarr[order]
        varr = np.ascontiguousarray(
            np.stack(rows, axis=0)[order], dtype=np.float32)
    tab._vec_base = (tab.base_ts, tab.schema, uarr, varr)
    return uarr, varr


def vector_view(tab, read_ts: int) -> VecView:
    """The tablet's vectors visible at read_ts. The base block is
    shared across calls; only the (usually tiny) overlay side block is
    built per read timestamp."""
    base_uids, base_vecs = _base_block(tab)
    dim = base_vecs.shape[1] if base_vecs.size else 0
    keep = np.ones(len(base_uids), bool)
    ex_uids: list[int] = []
    ex_rows: list[np.ndarray] = []
    if tab.dirty():
        touched = sorted(tab.overlay_srcs(read_ts))
        if touched:
            tarr = np.asarray(touched, np.uint64)
            pos = np.searchsorted(base_uids, tarr)
            pos = np.clip(pos, 0, max(len(base_uids) - 1, 0))
            hit = (base_uids[pos] == tarr) if len(base_uids) \
                else np.zeros(len(tarr), bool)
            keep[pos[hit]] = False
            for u in touched:
                vec = _posting_vec(tab, tab.get_postings(int(u), read_ts))
                if vec is None:
                    continue
                if dim == 0:
                    dim = len(vec)
                elif len(vec) != dim:
                    raise ValueError(
                        f"predicate {tab.pred!r} holds vectors of "
                        f"differing dimension ({dim} vs {len(vec)})")
                ex_uids.append(int(u))
                ex_rows.append(vec)
    if ex_uids:
        earr = np.asarray(ex_uids, np.uint64)
        order = np.argsort(earr, kind="stable")
        ex_u = earr[order]
        ex_v = np.ascontiguousarray(
            np.stack(ex_rows, axis=0)[order], dtype=np.float32)
    else:
        ex_u = _EMPTY_U64.copy()
        ex_v = np.empty((0, dim), np.float32)
    if not base_vecs.size and dim:
        base_vecs = np.empty((0, dim), np.float32)
    return VecView(dim, base_uids, base_vecs, keep, ex_u, ex_v)


# ---------------------------------------------------------------------------
# quantized IVF index (ops/ivf.py) — trained on clean base blocks,
# versioned per (base_ts, schema) exactly like the columnar exports
# ---------------------------------------------------------------------------


def vector_ivf(tab):
    """The tablet's trained quantized index, or None. Valid only for
    the CURRENT (base_ts, schema): a rollup that folds vector ops
    moves base_ts and the stale index silently disappears — overlay
    rows between rollups ride the exact path (vector_view), so
    snapshot semantics never depend on index freshness."""
    cached = getattr(tab, "_vec_ivf", None)
    if cached is not None and cached[0] == tab.base_ts \
            and cached[1] is tab.schema:
        return cached[2]
    return None


def build_ivf(tab, *, nlist=None, seed: int = 0,
              target_recall: float | None = None, min_rows: int = 0,
              force: bool = False):
    """Train (or reuse) the quantized index over the tablet's base
    block. Returns the index, or None when the block is empty /
    below min_rows. The build is deterministic per (block, seed):
    two replicas training over the same base state produce
    byte-identical codebooks — the property snapshot determinism
    (ingest/distributed.py) leans on."""
    from dgraph_tpu_torch.ops import ivf as _ivf
    from dgraph_tpu_torch.utils.tracing import span as _span

    cur = vector_ivf(tab)
    if cur is not None and not force:
        return cur
    _uids, vecs = _base_block(tab)
    n = len(vecs)
    if n == 0 or (not force and n < min_rows):
        return None
    failpoint.fire("vecstore.build")
    with _span("vector.build", pred=tab.pred, rows=n):
        kw = {}
        if target_recall is not None:
            kw["target_recall"] = float(target_recall)
        ix = _ivf.build(vecs, nlist=nlist, seed=seed,
                        device=tab.device, **kw)
    tab._vec_ivf = (tab.base_ts, tab.schema, ix)
    set_gauge("vector_index_bytes", float(ix.nbytes),
              labels={"predicate": tab.pred})
    return ix


def ivf_residency(tab) -> dict:
    """Vector-plane residency for tabstats: decoded base block bytes
    plus the quantized index's footprint (0 when stale/absent)."""
    out = {"vecBase": 0, "vecIndex": 0}
    vb = getattr(tab, "_vec_base", None)
    if vb is not None and vb[0] == tab.base_ts and vb[1] is tab.schema:
        out["vecBase"] = int(vb[3].nbytes + vb[2].nbytes)
    ix = vector_ivf(tab)
    if ix is not None:
        out["vecIndex"] = int(ix.nbytes)
    return out


def ivf_to_payload(ix) -> dict:
    """Index -> wire-shape dict for the snapshot plane. Arrays ship
    as raw little-endian bytes + shape so the payload is
    byte-deterministic (the group-varint planes' contract; float
    blocks don't delta-compress, they stay dense)."""
    return {
        "v": 1, "dim": ix.dim, "nlist": ix.nlist,
        "nprobe": ix.nprobe,
        "sample_recall": float(ix.sample_recall),
        "target_recall": float(ix.target_recall),
        "seed": int(ix.seed),
        "centroids": ix.centroids.tobytes(),
        "order": ix.order.tobytes(),
        "starts": ix.starts.tobytes(),
        "codes": ix.codes.tobytes(),
        "scales": ix.scales.tobytes(),
        "norms2": ix.norms2.tobytes(),
    }


def ivf_from_payload(st: dict, device=None):
    """Inverse of ivf_to_payload, with the index placed on `device`
    (None: the card)."""
    from dgraph_tpu_torch.backend import resolve_device
    from dgraph_tpu_torch.ops.ivf import IVFIndex
    d, nc = int(st["dim"]), int(st["nlist"])
    n = len(st["order"]) // 4
    return IVFIndex(
        dim=d, nlist=nc,
        centroids=np.frombuffer(st["centroids"], "<f4")
        .reshape(nc, d).copy(),
        order=np.frombuffer(st["order"], "<i4").copy(),
        starts=np.frombuffer(st["starts"], "<i8").copy(),
        codes=np.frombuffer(st["codes"], "i1").reshape(n, d).copy(),
        scales=np.frombuffer(st["scales"], "<f4").copy(),
        norms2=np.frombuffer(st["norms2"], "<f4").copy(),
        nprobe=int(st["nprobe"]),
        sample_recall=float(st["sample_recall"]),
        target_recall=float(st["target_recall"]),
        seed=int(st.get("seed", 0))).to_device(resolve_device(device))
