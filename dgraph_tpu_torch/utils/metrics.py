"""Process-wide named counters: the part of `dgraph_tpu/utils/metrics.py`
the vector plane uses. `ops/ivf.py` counts index builds and served
quantized searches here; a caller reads a count with `counter`."""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counts: dict[str, int] = {}


def inc_counter(name: str) -> None:
    """Add one to the counter `name`."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + 1


def counter(name: str) -> int:
    """The current value of the counter `name` (0 if never counted)."""
    with _lock:
        return _counts.get(name, 0)
