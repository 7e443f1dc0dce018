"""Metrics log of the port (counterpart of gdm_tpu/utils/logging.py's
JsonlLogger, with the same record format)."""

from __future__ import annotations

import json
import os
import time


class JsonlLogger:
    """Append-only JSONL metrics log: one dict per line, with a ``ts``
    (seconds since the epoch, 3 decimals) first.  Opens lazily, creates
    the parent directories and flushes every line, so a crashed run keeps
    what it logged."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def write(self, record: dict):
        if self._f is None:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            self._f = open(self.path, "a")
        rec = {"ts": round(time.time(), 3)}
        rec.update(record)
        self._f.write(json.dumps(rec, default=float) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
