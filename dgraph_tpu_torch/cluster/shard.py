"""Hash-range sub-tablets: one predicate split across groups.

The reference keeps a whole predicate on one group — a viral predicate
therefore pins its group forever, the named million-user failure mode
(ROADMAP item 4). A split partitions a predicate's rows by SUBJECT
uid hash into `nshards` ranges; each range ("sub-tablet") is owned by
a group independently in Zero's routing map (`splits` next to
`tablets`), writes route per resolved subject through the existing
2PC machinery, and reads fan out to every owner and union
(cluster/federated.py SplitRemoteTablet).

The hash must be (a) stable across processes/versions — routing and
data placement both derive from it, a drifting hash silently orphans
rows — and (b) well-mixed over dense sequential uid leases (uid % n
would stripe every entity batch onto one shard). splitmix64's
finalizer is the standard choice; implemented in pure ints, masked to
64 bits.
"""

from __future__ import annotations

_M = (1 << 64) - 1


def mix64(x: int) -> int:
    """splitmix64 finalizer: deterministic 64-bit mix."""
    x = (x + 0x9E3779B97F4A7C15) & _M
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M
    return x ^ (x >> 31)


def shard_of(uid: int, nshards: int) -> int:
    """The sub-tablet index owning SUBJECT `uid` of an n-way split."""
    if nshards <= 1:
        return 0
    return mix64(int(uid)) % int(nshards)


def shard_mask(uids, nshards: int, shard: int):
    """Vectorized membership: bool mask of `uids` (ndarray) whose
    shard_of == shard. numpy splitmix64 with wrapping uint64 ops."""
    import numpy as np
    x = np.asarray(uids, np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(nshards)) == np.uint64(shard)


def filter_ops(ops, nshards: int, shard: int,
               invert: bool = False) -> list:
    """The EdgeOps of one commit that land in `shard` (subject-hash
    routing: an op belongs where its src lives). `invert` keeps the
    complement — the source's post-split prune."""
    return [op for op in ops
            if (shard_of(int(op.src), nshards) == int(shard))
            != bool(invert)]


def shard_view(tab, nshards: int, shard: int, invert: bool = False):
    """A fresh Tablet holding exactly `tab`'s rows whose SUBJECT uid
    hashes into `shard` — the unit a split move snapshots/streams.
    Derived planes (token index, reverse) rebuild from the filtered
    base so they are exactly consistent with it; the trained vector
    index is deliberately NOT carried (it covers all rows — the
    destination retrains at rollup). Unfolded overlay deltas filter
    per-op, preserving commit timestamps, so CDC catch-up offsets
    stay aligned with the full tablet's. The view lives on `tab`'s
    device."""
    from dgraph_tpu_torch.storage.tablet import Tablet

    inv = bool(invert)
    keep = lambda src: \
        (shard_of(int(src), nshards) == int(shard)) != inv  # noqa: E731
    out = Tablet(tab.pred, tab.schema, device=tab.device)
    out.base_ts = tab.base_ts
    out.max_commit_ts = tab.max_commit_ts
    out.edges = {s: v.copy() for s, v in tab.edges.items() if keep(s)}
    out.values = {s: list(v) for s, v in tab.values.items() if keep(s)}
    out.edge_facets = {k: dict(v) for k, v in tab.edge_facets.items()
                       if keep(k[0])}
    out.deltas = [(ts, filter_ops(ops, nshards, shard, invert=inv))
                  for ts, ops in tab.deltas]
    out.rebuild_index()
    out.rebuild_reverse()
    return out


def owners_of(splits_entry: dict) -> list[int]:
    """The distinct owning groups of a split predicate, sorted."""
    return sorted(set(int(g) for g in splits_entry["owners"]))


def owner_for_uid(splits_entry: dict, uid: int) -> int:
    """The group serving SUBJECT `uid` of a split predicate."""
    owners = splits_entry["owners"]
    return int(owners[shard_of(int(uid), len(owners))])
