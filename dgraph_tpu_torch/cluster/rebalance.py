"""Heat-driven rebalance planning: pure policy over Zero's stats.

The reference rebalances by tablet SIZE every 8 minutes
(zero/tablet.go:62 rebalanceTablets / chooseTablet); size alone cannot
see the million-user failure mode — a small-but-viral predicate pins
its group's CPU while the byte spread looks balanced. This planner
weighs tablets by the HEAT EWMA Zero folds from the alphas' query-path
touch deltas (zero.py "tablet_heat"), falling back to bytes when the
cluster is idle, and adds the second tool size-rebalancing lacks
entirely: when one predicate IS the imbalance (moving it whole would
just relocate the hot spot), it proposes a hash-range SPLIT instead,
so the load divides across groups.

Pure functions over a plain state view — ZeroServer's leader loop
feeds it `ZeroState` fields and proposes the returned request; unit
tests feed it dicts.

Port of `dgraph_tpu/cluster/rebalance.py`: a copy, its imports pointed at
this package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class RebalanceConfig:
    # hysteresis band: act only when the heaviest group carries more
    # than `band`x the lightest's load AND the absolute spread clears
    # `min_spread` (tiny clusters must not thrash over noise)
    band: float = 1.4
    min_spread: float = 64.0
    # a predicate whose weight exceeds `split_frac` of its group's
    # load AND `split_heat` absolute heat splits 2-way instead of
    # moving whole. split_heat <= 0 disables splitting.
    split_frac: float = 0.5
    split_heat: float = 0.0
    split_shards: int = 2
    # never auto-move these predicates (operator pin,
    # --rebalance-pin): the knob for colocation constraints the
    # planner cannot see — e.g. a vector predicate and the attributes
    # its similar_to queries select (cross-group vector search is not
    # supported), or a bundle an SLA wants welded to local reads
    pinned: frozenset = frozenset()


@dataclass
class RebalancePlan:
    kind: str            # "move" | "split"
    pred: str
    dst: int
    nshards: int = 1
    shard: Optional[int] = None

    def args(self) -> tuple:
        """The ("move_request", args) payload (cluster/zero.py)."""
        if self.kind == "split":
            return (self.pred, self.dst, self.nshards, self.shard)
        return (self.pred, self.dst)


def tablet_weights(view: dict) -> dict[str, float]:
    """Per-tablet load weight: heat EWMA when the cluster shows any
    (the signal that sees viral predicates), bytes otherwise (the
    reference's size heuristic, the right call for an idle cluster
    being packed)."""
    heat = view.get("heat", {})
    sizes = view.get("sizes", {})
    preds = set(view.get("tablets", ())) | set(view.get("splits", ()))
    if any(heat.get(p, 0.0) > 0.0 for p in preds):
        return {p: float(heat.get(p, 0.0)) for p in preds}
    return {p: float(sizes.get(p, 0)) for p in preds}


def group_loads(view: dict, weights: dict[str, float]) -> dict[int, float]:
    """Group -> summed tablet weight. A split predicate contributes
    one even share per shard to each shard's owner (the per-shard heat
    is not tracked separately; even division is the unbiased prior)."""
    loads = {int(g): 0.0 for g in view.get("groups", ())}
    for pred, gid in view.get("tablets", {}).items():
        if pred.startswith("dgraph."):
            continue
        loads[int(gid)] = loads.get(int(gid), 0.0) \
            + weights.get(pred, 0.0)
    for pred, ent in view.get("splits", {}).items():
        owners = ent["owners"]
        share = weights.get(pred, 0.0) / max(1, len(owners))
        for gid in owners:
            loads[int(gid)] = loads.get(int(gid), 0.0) + share
    return loads


def plan_rebalance(view: dict,
                   cfg: Optional[RebalanceConfig] = None
                   ) -> Optional[RebalancePlan]:
    """At most ONE proposed action per call (the ledger executes moves
    serially; one step per tick keeps a bad heuristic from thrashing).
    None = balanced within the hysteresis band, or nothing movable."""
    cfg = cfg or RebalanceConfig()
    if view.get("moving") or len(view.get("groups", ())) < 2:
        return None
    weights = tablet_weights(view)
    loads = group_loads(view, weights)
    if len(loads) < 2:
        return None
    heavy = max(sorted(loads), key=lambda g: loads[g])
    light = min(sorted(loads), key=lambda g: loads[g])
    spread = loads[heavy] - loads[light]
    if spread < cfg.min_spread or \
            loads[heavy] <= cfg.band * max(loads[light], 1e-9):
        return None
    frozen = set(cfg.pinned) | set(view.get("frozen", ()))
    movable = sorted(p for p, g in view.get("tablets", {}).items()
                     if int(g) == heavy and not p.startswith("dgraph.")
                     and p not in frozen)
    if not movable:
        return None
    # the dominant-predicate test first: when one tablet IS the load,
    # moving it whole only mirrors the imbalance — split it instead
    hot = max(movable, key=lambda p: (weights.get(p, 0.0), p))
    hot_w = weights.get(hot, 0.0)
    heat = view.get("heat", {})
    if cfg.split_heat > 0 and heat.get(hot, 0.0) >= cfg.split_heat \
            and hot_w > cfg.split_frac * loads[heavy]:
        return RebalancePlan("split", hot, light,
                             nshards=cfg.split_shards,
                             shard=cfg.split_shards - 1)
    # otherwise the reference's chooseTablet rule, heat-weighted: the
    # SMALLEST candidate whose move strictly shrinks the pair's
    # spread. Smallest-first is deliberate, twice over: each move's
    # blast radius (stream bytes, fence, routing churn, queries that
    # temporarily federate when one predicate of a colocated bundle
    # moves ahead of its siblings) stays minimal, and the dominant
    # hot tablet stays put unless nothing smaller can help — at which
    # point the SPLIT above is the right tool, not a whole-tablet
    # move that merely relocates the hot spot.
    for pred in sorted(movable,
                       key=lambda p: (weights.get(p, 0.0), p)):
        w = weights.get(pred, 0.0)
        if abs((loads[heavy] - w) - (loads[light] + w)) < spread:
            return RebalancePlan("move", pred, light)
    return None
