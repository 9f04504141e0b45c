"""Device snapshot management: host tablets -> resident device tiles.

The policy mirrors the reference's MVCC read path split (posting/list.go
immutable layer vs mutation layer): the *rolled-up* committed state lives
on device; while a tablet has live deltas (posting/mvcc.go mutation
layers) reads stay on the host overlay. Once rollup folds the overlay
(watermark = min active ts, ref worker/draft.go:1206), the tablet is
re-packed and uploaded lazily on first use.

Device tiles hold uint32 uid values (rebased): the engine checks the
tablet's max uid; >32-bit graphs fall back to host until uid-range
partitioning (parallel/) is wired in — the reference's own UidPack
blocks make the same 32-bit-low-word assumption per block
(codec/codec.go:43).

Port of `dgraph_tpu/engine/device_cache.py`. Tiles are built on the
tablet's device (`Tablet.device`) by the port's `ops/graph` and
`ops/bitgraph`, whose uid tensors are int64 holding uint32 values.
`expand_np` calls `graph.expand` directly and caches `max_expansion`
per padded frontier size, where the reference caches a jitted expander.
`device_sharded_adjacency` needs a device mesh, which comes with the
multi-device slice (ROADMAP Queue 1 item 8): until then it answers None,
as the reference does without a mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dgraph_tpu_torch.engine.tile_cache import DeviceCacheLRU  # noqa: F401
from dgraph_tpu_torch.ops.graph import (
    DeviceAdjacency, build_adjacency, build_values, expand, max_expansion,
)
from dgraph_tpu_torch.ops.uidvec import SENTINEL, pad_to, to_numpy
from dgraph_tpu_torch.utils.tracing import span as _span

_MAX_U32 = 0xFFFFFFFE  # SENTINEL reserved


def device_adjacency(db, tab, read_ts: int,
                     allow_dirty: bool = False
                     ) -> Optional[DeviceAdjacency]:
    """allow_dirty=True returns the tile built from the BASE arrays
    even while an overlay exists — callers doing overlay-on-device
    reads (executor._device_expand) answer overlay-touched rows on the
    host and use the tile only for untouched rows. Everyone else gets
    the strict clean-only contract."""
    if not _clean_resident(db, tab, read_ts, allow_dirty=allow_dirty):
        return None
    adj = getattr(tab, "_device_adj", None)
    if adj is not None and tab._device_adj_ts == tab.base_ts:
        db.device_cache.touch(tab, "_device_adj")
        return adj
    n_edges = sum(len(v) for v in tab.edges.values())
    if n_edges < db.device_min_edges:
        return None
    edges32 = _edges32(tab.edges)
    if edges32 is None:
        return None
    with _span("device.tile_load", pred=tab.pred, kind="adj",
               edges=n_edges):
        adj = build_adjacency(edges32, device=tab.device)
    tab._device_adj = adj
    tab._device_adj_ts = tab.base_ts
    db.device_cache.put(tab, "_device_adj", adj)
    return adj


def _clean_resident(db, tab, read_ts: int, want_uid: bool = True,
                    allow_dirty: bool = False) -> bool:
    """Shared residency policy: rolled-up committed state only.

    Rollup folds the delta overlay into the base arrays — a WRITE. In
    single-threaded embedded use it may run lazily right here, but a
    server running queries concurrently (read lock shared) must set
    db.rollup_in_read = False and fold from its write path instead
    (server/http.py janitor), or concurrent readers would see torn
    tablets."""
    if (tab.schema.value_type.name == "UID") != want_uid:
        return False
    if tab.dirty():
        if getattr(db, "rollup_in_read", True):
            wm = db.fold_watermark()
            if wm >= tab.max_commit_ts:
                tab.rollup(wm)
        if tab.dirty() and not allow_dirty:
            return False  # live overlay -> host path
    return read_ts >= tab.base_ts


def _edges32(edge_dict) -> Optional[dict]:
    edges32 = {}
    for src, dst in edge_dict.items():
        if src > _MAX_U32 or (len(dst) and int(dst[-1]) > _MAX_U32):
            return None
        edges32[int(src)] = dst.astype(np.uint32)
    return edges32


def _transposed_edges(tab) -> dict:
    """{dst -> sorted src} for a tablet, regardless of @reverse (the
    schema directive gates *queryable* reverse edges; SSSP path
    reconstruction needs the transpose either way)."""
    if tab.schema.reverse and tab.reverse:
        return tab.reverse
    srcs = []
    dsts = []
    for s, dl in tab.edges.items():
        srcs.append(np.full(len(dl), s, np.uint64))
        dsts.append(dl)
    if not srcs:
        return {}
    src_all = np.concatenate(srcs)
    dst_all = np.concatenate(dsts)
    order = np.argsort(dst_all, kind="stable")
    src_all, dst_all = src_all[order], dst_all[order]
    uniq, starts = np.unique(dst_all, return_index=True)
    bounds = np.append(starts, len(dst_all))
    return {int(d): np.sort(src_all[bounds[i]: bounds[i + 1]])
            for i, d in enumerate(uniq)}


def device_radjacency(db, tab, read_ts: int,
                      allow_dirty: bool = False
                      ) -> Optional[DeviceAdjacency]:
    """Reverse-direction expansion tiles (~pred traversal): a
    DeviceAdjacency over the tablet's reverse map. Requires @reverse
    (the executor rejects ~pred queries otherwise). allow_dirty as in
    device_adjacency."""
    if not tab.schema.reverse or not _clean_resident(
            db, tab, read_ts, allow_dirty=allow_dirty):
        return None
    adj = getattr(tab, "_device_radj", None)
    if adj is not None and getattr(tab, "_device_radj_ts", -1) == tab.base_ts:
        db.device_cache.touch(tab, "_device_radj")
        return adj
    n_edges = sum(len(v) for v in tab.reverse.values())
    if n_edges < db.device_min_edges:
        return None
    edges32 = _edges32(tab.reverse)
    if edges32 is None:
        return None
    with _span("device.tile_load", pred=tab.pred, kind="radj",
               edges=n_edges):
        adj = build_adjacency(edges32, device=tab.device)
    tab._device_radj = adj
    tab._device_radj_ts = tab.base_ts
    db.device_cache.put(tab, "_device_radj", adj)
    return adj


def device_bitadjacency(db, tab, read_ts: int, transpose: bool = False):
    """Bitmap adjacency (ops/bitgraph) for analytical BFS/SSSP.
    Same residency policy as device_adjacency: clean rolled-up tablets
    only; cached per base_ts. With transpose=True the expansion walks
    edges dst->src (used for distance-to-target in shortest paths)."""
    if not _clean_resident(db, tab, read_ts):
        return None
    attr = "_device_badj_t" if transpose else "_device_badj"
    badj = getattr(tab, attr, None)
    if badj is not None and getattr(tab, attr + "_ts", -1) == tab.base_ts:
        db.device_cache.touch(tab, attr)
        return badj
    n_edges = sum(len(v) for v in tab.edges.values())
    if n_edges < db.device_min_edges:
        return None
    edges32 = _edges32(_transposed_edges(tab) if transpose else tab.edges)
    if edges32 is None:
        return None
    from dgraph_tpu_torch.ops.bitgraph import build_bitadjacency
    with _span("device.tile_load", pred=tab.pred, kind="bitadj",
               edges=n_edges):
        badj = build_bitadjacency(edges32, device=tab.device)
    setattr(tab, attr, badj)
    setattr(tab, attr + "_ts", tab.base_ts)
    db.device_cache.put(tab, attr, badj)
    return badj


def device_sharded_adjacency(db, tab, read_ts: int,
                             reverse: bool = False):
    """UID-range-sharded adjacency over the engine's device mesh — the
    multi-part posting list tier (posting/list.go:1149 splitUpList).
    The port's engine has no mesh yet (ROADMAP Queue 1 item 8;
    `GraphDB(mesh=...)` raises), so this answers None, as the
    reference's does without one."""
    return None


def host_column_tile(db, tab, attr: str, obj) -> None:
    """Account a host-side columnar export (value-column view, token
    CSR) against the tile budget under the same LRU + eviction policy
    as the device tiles: the payload copies are NOT free host memory,
    and eviction clears the tablet attribute (`attr`/`attr`+"_ts") so
    the next consumer rebuilds. Put only on first sight — a put per
    query would re-scan the LRU under its lock for nothing."""
    cache = db.device_cache
    if not cache.touch(tab, attr):
        cache.put(tab, attr, obj)


def device_values(db, tab, read_ts: int, lang: str = ""):
    """Sortable value view for order-by / inequality offload (scalar
    tablets; same rollup-then-check policy as the adjacency tiles).
    `lang` selects language-tagged order keys (ref worker/sort.go
    multiSort with langs) — each language gets its own cached tile."""
    if not _clean_resident(db, tab, read_ts, want_uid=False):
        return None
    attr = "_device_values" if not lang else f"_device_values@{lang}"
    dv = getattr(tab, attr, None)
    if dv is not None and getattr(tab, attr + "_ts", -1) == tab.base_ts:
        db.device_cache.touch(tab, attr)
        return dv
    pairs = tab.sort_key_pairs(lang)
    if len(pairs) < db.device_min_edges:
        return None
    if pairs and max(pairs) > _MAX_U32:
        return None
    with _span("device.tile_load", pred=tab.pred, kind="values",
               rows=len(pairs)):
        dv = build_values(pairs, device=tab.device)
    setattr(tab, attr, dv)
    setattr(tab, attr + "_ts", tab.base_ts)
    db.device_cache.put(tab, attr, dv)
    return dv


def expand_np(adj: DeviceAdjacency, src_u64: np.ndarray) -> np.ndarray:
    """Host frontier -> device expand -> host result.

    The expansion bound `max_expansion` is cached per (frontier bucket
    size) on the adjacency object, so repeated traversal levels reuse
    it.
    """
    # uids beyond uint32 cannot exist in a <=32-bit tablet: drop them
    # instead of letting them alias onto real low uids. Sort: the
    # kernels' membership tests binary-search INTO the frontier, and
    # callers (e.g. order-by results) may pass any order.
    src_u64 = np.sort(src_u64[src_u64 <= _MAX_U32])
    f_pad = pad_to(len(src_u64))
    cache = getattr(adj, "_expander_cache", None)
    if cache is None:
        cache = adj._expander_cache = {}
    out_size = cache.get(f_pad)
    if out_size is None:
        out_size = cache[f_pad] = max_expansion(adj, f_pad)
    fr = np.full(f_pad, SENTINEL, np.int64)
    fr[: len(src_u64)] = src_u64.astype(np.int64)
    res = expand(adj, torch.from_numpy(fr).to(adj.src_uids.device),
                 out_size)
    return to_numpy(res).astype(np.uint64)
