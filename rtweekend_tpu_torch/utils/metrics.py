"""Structured metrics logging as JSON lines (rtweekend_tpu.utils.metrics).

Events are newline-delimited JSON (pipe them into jq or a collector),
with the JAX package's event names and fields. The render driver never
waits for the device between batches, so `batch_submitted` times
submission; `render_done` comes after a device sync and its rays/s is
measured against completion.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


class MetricsLogger:
    """Newline-delimited JSON event logger to `path` (appended), else to
    `stream`, else to stderr. Every event carries a monotonic `t_s`
    (seconds since the logger was made) and the wall-clock `ts`."""

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None):
        self._own = path is not None
        self._f = open(path, "a") if self._own else (stream or sys.stderr)
        self._t0 = time.perf_counter()

    def log(self, event: str, **fields) -> None:
        rec = {"event": event, "ts": round(time.time(), 3),
               "t_s": round(time.perf_counter() - self._t0, 4)}
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
