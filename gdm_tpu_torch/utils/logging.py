"""Metrics log and profiler trace of the port (counterparts of
gdm_tpu/utils/logging.py's JsonlLogger, with the same record format, and
of its profiler_trace)."""

from __future__ import annotations

import contextlib
import json
import os
import os.path as osp
import re
import time


@contextlib.contextmanager
def profiler_trace(log_dir: str | None, cuda: bool = False):
    """A ``torch.profiler`` trace of the block, written as one chrome
    trace (``trace_<pid>_<time>.json``) into ``log_dir``; nothing when
    ``log_dir`` is None.

    With ``cuda`` the trace records the CUDA activity (kernels, copies)
    beside the host's, and a trace that holds no kernel raises: without
    CUPTI the profiler would quietly trace the host alone."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda and not torch.cuda.is_available():
        raise RuntimeError("a CUDA trace asked for, but CUDA is not "
                           "available")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    path = osp.join(log_dir, f"trace_{os.getpid()}_"
                             f"{time.strftime('%Y%m%d_%H%M%S')}.json")
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)
    if cuda:
        with open(path) as f:
            if not re.search(r'"cat"\s*:\s*"kernel"', f.read()):
                raise RuntimeError(f"{path}: the CUDA trace holds no "
                                   "kernel event (is CUPTI missing?)")


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
