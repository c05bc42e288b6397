"""Host-side batching loader with threaded item fetch and batch prefetch (a
copy of sv3d_tpu/data/loader.py, whose notes below speak of its JAX host).

Replaces the reference's torch DataLoader(num_workers, pin_memory) host
pipeline (reference trainer/trainer_scene_net.py:57-67).  Differences shaped
by the TPU runtime:
  * THREADS, not processes: the datasets are numpy + codec work that releases
    the GIL (PNG/EXR decode, npz decompress), samples are LRU-cached, and
    device transfer happens later via jax.device_put / shard_batch — no
    pin_memory analog needed.
  * Determinism does not depend on worker scheduling: per-item randomness is
    keyed (seed, epoch, index) inside the dataset (datasets.get), and batch
    order is fixed by a (seed, epoch)-seeded permutation.
  * Multi-host (DCN) data feeding: pass process_index/process_count and every
    process iterates the SAME global batch order (same seed) but materializes
    only its contiguous slice of each batch — the row layout shard_batch's dp
    sharding expects, so jax.make_array_from_process_local_data-style
    assembly stays trivial.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

from sv3d_tpu_torch.utils.profiling import span


def collate(samples: list) -> dict:
    """Stack a list of sample dicts into one batch dict: numpy arrays gain a
    leading batch axis; everything else (names, mesh paths) becomes a list."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals, axis=0)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = list(vals)
    return out


class DataLoader:
    """Iterable over collated batches of a map-style dataset.

    len() counts GLOBAL batches; under multi-host slicing each yielded batch
    holds batch_size / process_count rows (this process's contiguous slice).
    Iterating the same loader again advances the epoch: shuffle order and the
    datasets' subsample draws both refresh.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 0,
        seed: int = 0,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if process_count > 1 and batch_size % process_count != 0:
            raise ValueError(
                f"batch_size {batch_size} not divisible by process_count {process_count}"
            )
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.num_workers = int(num_workers)
        self.seed = int(seed)
        self.prefetch = int(prefetch)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size) if n else 0

    def _batches(self, epoch: int):
        """Index lists for this process's slice of every global batch."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed & 0x7FFFFFFF, epoch])
            ).shuffle(order)
        per = self.batch_size // self.process_count
        lo = self.process_index * per
        for b in range(len(self)):
            rows = order[b * self.batch_size : (b + 1) * self.batch_size]
            if len(rows) < self.batch_size:
                # wraparound-pad a partial final batch (drop_last=False) with
                # duplicates from the start of the epoch order (the
                # DDP-sampler convention).  Applied in EVERY mode so (a)
                # multi-host assembly gets equal per-process row counts, (b)
                # single- and multi-process runs see identical effective
                # epochs, and (c) the jitted train step keeps one static
                # batch shape (a short final batch would force a recompile).
                pad = self.batch_size - len(rows)
                rows = np.concatenate([rows, np.resize(order, pad)])
            if self.process_count > 1:
                yield list(rows[lo : lo + per])
            else:
                yield list(rows)

    def _fetch(self, idx: int, epoch: int):
        get = getattr(self.dataset, "get", None)
        return get(idx, epoch) if get is not None else self.dataset[idx]

    def _collate(self, items: list) -> dict:
        """One yielded batch (span data.batch): its items, each a call that
        fetches it or reads its prefetched future, and collate."""
        with span("data.batch"):
            return collate([item() for item in items])

    def __iter__(self):
        epoch = self._epoch
        self._epoch += 1
        if self.num_workers <= 0:
            for rows in self._batches(epoch):
                yield self._collate([partial(self._fetch, i, epoch) for i in rows])
            return
        # threaded fetch with bounded look-ahead: keep `prefetch` extra
        # batches' worth of item futures in flight beyond the one being
        # yielded, so decode overlaps with the training step
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            in_flight: deque = deque()
            for rows in self._batches(epoch):
                in_flight.append([pool.submit(self._fetch, i, epoch) for i in rows])
                if len(in_flight) > self.prefetch:
                    yield self._collate([f.result for f in in_flight.popleft()])
            while in_flight:
                yield self._collate([f.result for f in in_flight.popleft()])
