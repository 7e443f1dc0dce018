"""Ordered, prefetching batch loader (host side).

Counterpart of gdm_tpu/data/loader.py as evaluation uses it
(``shuffle=False, drop_last=False``, thread workers): a thread pool
decodes and crops the samples of a batch concurrently while the device
runs the previous batch, and a bounded queue holds the batches ready.
Threads suffice: zlib, the C++ PNG row filter and the large numpy
operations of the crop release the GIL.  Batches come in dataset order,
the trailing one partial; :func:`pad_batch` pads it to the engine's batch.
Process workers, shuffling and sharding come with the training slice.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def collate(samples: list[dict]) -> tuple[dict, list[dict]]:
    """Stack numeric fields; collect non-array fields into a meta list."""
    batch, meta = {}, [{} for _ in samples]
    for k, v in samples[0].items():
        if isinstance(v, (np.ndarray, np.integer, np.floating, int,
                          float, bool)):
            batch[k] = np.stack([np.asarray(s[k]) for s in samples])
        else:
            for i, s in enumerate(samples):
                meta[i][k] = s[k]
    return batch, meta


def pad_batch(batch: dict, bs: int) -> dict:
    """Pad a trailing partial batch to ``bs`` rows by repeating its last
    row (gdm_tpu/cli.py _pad_batch); callers drop the padded results."""
    n_real = next(iter(batch.values())).shape[0]
    if n_real >= bs:
        return batch
    pad = bs - n_real
    return {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)])
            for k, v in batch.items()}


class DataLoader:
    """Iterate a dataset in order, in batches of ``batch_size`` (the last
    one partial), decoded by ``num_workers`` threads and prefetched up to
    ``prefetch`` batches ahead.  Yields (batch dict, meta list)."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 8,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        n, bs = len(self.dataset), self.batch_size
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Stop-aware put: a consumer that abandons iteration sets
            ``stop`` with the queue full, and a blocking put would park
            this thread and its pool forever."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for start in range(0, n, bs):
                    if stop.is_set():
                        return
                    idx = range(start, min(start + bs, n))
                    try:
                        samples = list(pool.map(self.dataset.__getitem__,
                                                idx))
                        if not put(collate(samples)):
                            return
                    except Exception as e:          # surface in consumer
                        put(e)
                        return
            put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
