"""Structured logging: JSON lines to stderr.

The reference logs through glog with -v levels (x/x.go init,
worker/draft.go event logging); operators scrape those lines. Here
every event is one JSON object — machine-parseable, grep-friendly —
with a process-wide minimum level and no dependencies.

    from dgraph_tpu_torch.utils.logger import log
    log.info("leader_changed", group=1, leader=2, term=7)

Port of `dgraph_tpu/utils/logger.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


class _Logger:
    def __init__(self):
        self._lock = threading.Lock()
        self.min_level = _LEVELS.get(
            os.environ.get("DGRAPH_TPU_LOG_LEVEL", "info"), 20)
        self.stream = sys.stderr

    def _emit(self, level: str, event: str, fields: dict):
        if _LEVELS[level] < self.min_level:
            return
        # wall clock: log timestamps are user-visible instants
        rec = {"ts": round(time.time(), 3), "level": level,  # dglint: disable=DG06
               "event": event}
        for k, v in fields.items():
            if k not in rec:
                rec[k] = v if isinstance(
                    v, (str, int, float, bool, type(None))) else str(v)
        line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            try:
                self.stream.write(line + "\n")
                self.stream.flush()
            except (OSError, ValueError):
                pass  # closed stream during shutdown

    def debug(self, event: str, **fields):
        self._emit("debug", event, fields)

    def info(self, event: str, **fields):
        self._emit("info", event, fields)

    def warning(self, event: str, **fields):
        self._emit("warning", event, fields)

    def error(self, event: str, **fields):
        self._emit("error", event, fields)


log = _Logger()
