"""Columnar value variables: (sorted uids, numpy values) instead of
dict[int, Val].

The reference flows value variables between blocks as Go maps of typed
values (query/query.go valueVarAggregation, aggregator.go:435,
math.go:213).  Round 3 bound vars columnarly but every CONSUMER still
materialized a python dict and walked it per uid — q020-style
aggregation at the 21M regime spent seconds in those walks.  A ColVar
keeps the two parallel arrays end-to-end; math, aggregation,
`eq/le/ge(val(v), …)` filters and val() order keys all consume the
arrays directly.  Legacy consumers (mixed-type vars, facet vars,
string vars) still see a Mapping: iteration/len/contains are answered
from the uid array, and only __getitem__/items/values materialize the
dict — so the slow path is paid exactly where the dict path was the
status quo.

Value semantics mirror the dict path bit-for-bit:
  * math runs in float64 (the dict path converts every leaf with
    float(), so this is not a new rounding surface);
  * aggregation sums sequentially over the python list of the gathered
    column, matching the committed goldens' left-fold rounding;
  * materialization converts integral math results back to INT per
    element exactly like _eval_math's tail did.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional

import numpy as np

from dgraph_tpu_torch.models.types import TypeID, Val

_NUMERIC = (TypeID.INT, TypeID.FLOAT, TypeID.BOOL)


class ColVar(Mapping):
    """A value variable as parallel arrays.

    uids:  uint64, sorted ascending, unique
    vals:  int64 (INT), float64 (FLOAT / math results), uint8 (BOOL)
    tid:   the Val type materialized entries carry
    frac:  math-result flag — materialize per-element INT-if-integral
           (matches _eval_math's historical output typing)
    isbool: math comparison result — materialize as BOOL
    """

    __slots__ = ("uids", "vals", "tid", "frac", "isbool", "objs",
                 "_d")

    def __init__(self, uids: np.ndarray, vals: np.ndarray, tid: TypeID,
                 frac: bool = False, isbool: bool = False, objs=None):
        self.uids = uids
        self.vals = vals
        self.tid = tid
        self.frac = frac
        self.isbool = isbool
        # DATETIME vars: vals carry float epoch seconds (the domain
        # math works in, aggregator.go applySince semantics) while
        # objs holds the EXACT datetime objects for materialization —
        # reconstruction from floats would lose precision and tz
        self.objs = objs
        self._d: Optional[dict] = None

    # -- Mapping protocol: cheap paths never materialize ---------------

    def __len__(self) -> int:
        return len(self.uids)

    def __iter__(self):
        return iter(self.uids.tolist())

    def __contains__(self, u) -> bool:
        i = np.searchsorted(self.uids, np.uint64(u))
        return i < len(self.uids) and int(self.uids[i]) == int(u)

    def __getitem__(self, u) -> Val:
        return self.dict()[u]

    def get(self, u, default=None):
        return self.dict().get(u, default)

    def items(self):
        return self.dict().items()

    def values(self):
        return self.dict().values()

    def keys(self):
        return self.dict().keys()

    # -- columnar API --------------------------------------------------

    def gather(self, uids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(present_uids, their values) for a sorted uid array — one
        searchsorted instead of per-uid dict probes; a gather over the
        var's own domain (filters/aggregates on the binding block's
        uids, the q020 shape) short-circuits to the arrays as-is."""
        if not len(uids) or not len(self.uids):
            return uids[:0], self.vals[:0]
        if len(uids) == len(self.uids) and (uids is self.uids or (
                uids[0] == self.uids[0] and uids[-1] == self.uids[-1]
                and np.array_equal(uids, self.uids))):
            # endpoint probes reject length-equal misses before the
            # full O(n) compare (array_equal does not short-circuit)
            return self.uids, self.vals
        pos = np.searchsorted(self.uids, uids)
        pos = np.minimum(pos, len(self.uids) - 1)
        hit = self.uids[pos] == uids
        return uids[hit], self.vals[pos[hit]]

    def to_val(self, x) -> Val:
        """One element → Val, with math-result typing rules."""
        if self.isbool:
            return Val(TypeID.BOOL, bool(x))
        if self.frac:
            f = float(x)
            if f.is_integer() and abs(f) < 2 ** 53:
                return Val(TypeID.INT, int(f))
            return Val(TypeID.FLOAT, f)
        if self.tid == TypeID.BOOL:
            return Val(TypeID.BOOL, bool(x))
        if self.tid == TypeID.INT:
            return Val(TypeID.INT, int(x))
        if self.tid == TypeID.FLOAT:
            return Val(TypeID.FLOAT, float(x))
        return Val(self.tid, x)

    def dict(self) -> dict:
        if self._d is None:
            if self.objs is not None:
                self._d = {u: Val(self.tid, o) for u, o in
                           zip(self.uids.tolist(), self.objs.tolist())}
            else:
                self._d = {u: self.to_val(v) for u, v in
                           zip(self.uids.tolist(), self.vals.tolist())}
        return self._d

    def floats(self) -> np.ndarray:
        """Values as float64 — the domain _eval_math works in."""
        return self.vals.astype(np.float64, copy=False)

    def take(self, uids: np.ndarray) -> "ColVar":
        """Subset ColVar for a sorted uid array, preserving the exact
        object column when present."""
        if not len(uids) or not len(self.uids):
            return ColVar(uids[:0], self.vals[:0], self.tid, self.frac,
                          self.isbool,
                          None if self.objs is None else self.objs[:0])
        if len(uids) == len(self.uids) and (uids is self.uids or (
                uids[0] == self.uids[0] and uids[-1] == self.uids[-1]
                and np.array_equal(uids, self.uids))):
            return self
        pos = np.searchsorted(self.uids, uids)
        pos = np.minimum(pos, len(self.uids) - 1)
        hit = self.uids[pos] == uids
        sel = pos[hit]
        return ColVar(uids[hit], self.vals[sel], self.tid, self.frac,
                      self.isbool,
                      None if self.objs is None else self.objs[sel])

    def sort_keys(self) -> np.ndarray:
        """Order-preserving int64 keys, vectorizing models.types.sort_key
        for the numeric types a ColVar carries."""
        if self.tid == TypeID.DATETIME and self.objs is not None:
            from dgraph_tpu_torch.models.types import sort_key
            return np.fromiter(
                (sort_key(Val(TypeID.DATETIME, o))
                 for o in self.objs.tolist()),
                np.int64, len(self.objs))
        if self.isbool or self.tid == TypeID.BOOL:
            return self.vals.astype(np.int64)
        if self.frac:
            # math results: INT-if-integral typing doesn't change the
            # ORDER, and float keys order identically to int keys for
            # integral values — use the float key uniformly
            return _float_sort_keys(self.floats())
        if self.tid == TypeID.INT:
            return self.vals.astype(np.int64, copy=False)
        if self.tid == TypeID.FLOAT:
            return _float_sort_keys(self.vals)
        raise ValueError("unsortable colvar")


def _float_sort_keys(a: np.ndarray) -> np.ndarray:
    """IEEE754 total-order trick, elementwise (types.sort_key)."""
    bits = a.astype(np.float64).view(np.int64)
    u = np.where(bits < 0, ~bits.view(np.uint64),
                 bits.view(np.uint64) | np.uint64(1 << 63))
    return (u - np.uint64(1 << 63)).view(np.int64)


def make_colvar(uids: np.ndarray, vals: np.ndarray,
                tid: TypeID) -> Optional[ColVar]:
    """ColVar for a numeric column; None for types the columnar
    pipeline doesn't carry (strings/datetimes keep the dict path)."""
    if tid not in _NUMERIC:
        return None
    if tid == TypeID.INT:
        vals = vals.astype(np.int64, copy=False)
    elif tid == TypeID.FLOAT:
        vals = vals.astype(np.float64, copy=False)
    else:
        vals = vals.astype(np.uint8, copy=False)
    return ColVar(uids, vals, tid)
