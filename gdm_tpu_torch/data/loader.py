"""Prefetching batch loader (host side).

Counterpart of gdm_tpu/data/loader.py (reference torch DataLoader +
DistributedSampler, train_lm.py:399-408): a pool decodes and crops the
samples of a batch concurrently while the device runs the previous batch,
and a bounded queue holds the batches ready.

  * ``shuffle`` draws each epoch's order from RandomState(seed + epoch)
    (``set_epoch``, as DistributedSampler), the JAX package's order to the
    index; ``rank``/``world`` take an interleaved slice of it;
  * ``drop_last`` drops the trailing partial batch (training), and first
    the last ``len % world`` rows of the order, so that every rank runs
    the same steps (DistributedSampler's ``drop_last``; the JAX loader
    slices without it); without it the last batch is partial and
    :func:`pad_batch` pads it to the engine's batch (evaluation);
  * ``workers='thread'`` (default) decodes in threads: zlib, the C++ PNG
    and JPEG decoders and the large numpy operations release the GIL;
    ``workers='process'`` in processes started with ``spawn`` (never
    ``fork``: the parent may hold CUDA), each holding its own copy of the
    dataset, shipped once when the pool starts.  Workers never touch CUDA.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

# the dataset of a process worker, set once by the pool's initializer
_worker_dataset = None


def _init_worker(dataset):
    global _worker_dataset
    _worker_dataset = dataset


def _worker_get(i):
    return _worker_dataset[i]


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
    """Iterate a dataset in batches of ``batch_size``, decoded by
    ``num_workers`` threads or processes and prefetched up to
    ``prefetch`` batches ahead.  Yields (batch dict, meta list)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 8,
                 prefetch: int = 2, seed: int = 0, rank: int = 0,
                 world: int = 1, workers: str = "thread"):
        if workers not in ("thread", "process"):
            raise ValueError(f"workers {workers!r}: 'thread' or 'process'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.rank, self.world = rank, world
        self.workers = workers
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            # the dataset mixes the epoch into its train rng; process
            # pools ship the dataset at __iter__ time, so it reaches them
            self.dataset.set_epoch(epoch)

    def epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = (np.random.RandomState(self.seed + self.epoch).permutation(n)
                 if self.shuffle else np.arange(n))
        if self.drop_last:
            # every rank takes as many rows: a rank with one more would
            # run a step whose collectives meet the others' next ones
            order = order[:n - n % self.world]
        return order[self.rank::self.world]

    def __len__(self):
        n = len(self.epoch_indices())
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _pool(self):
        if self.workers == "process":
            return ProcessPoolExecutor(
                self.num_workers, mp_context=multiprocessing.get_context(
                    "spawn"), initializer=_init_worker,
                initargs=(self.dataset,)), _worker_get
        return ThreadPoolExecutor(self.num_workers), self.dataset.__getitem__

    def __iter__(self):
        idxs = self.epoch_indices()
        n_batches, bs = len(self), self.batch_size
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
            try:
                pool, get = self._pool()
            except Exception as e:                  # surface in consumer
                put(e)
                return
            with pool:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    try:
                        samples = list(pool.map(get,
                                                idxs[b * bs:(b + 1) * bs]))
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
