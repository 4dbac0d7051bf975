"""Batched, prefetching data loader (host side).

Counterpart of `butd_detr_tpu/data/loader.py` (which replaces the
reference's torch DataLoader + DistributedSampler, main_utils.py:197-233):

  * fixed-shape numpy batches (every sample is already padded);
  * a contiguous shard of the (shuffled) index order per process;
  * the rows of one dp shard (`dp_index`, `dp_size`): `batch_size` is the
    batch of one step across the dp shards, as the JAX loader's batch is
    the one that its process's dp devices split. Shard i makes rows
    [i·B/dp, (i+1)·B/dp) of every batch of the one-shard loader, with the
    same order and the same per-index seeds, so its samples are that
    loader's; `"__valid__"` still counts the whole batch's real rows;
  * deterministic seeding: shuffle = f(seed, epoch), sample rng =
    f(seed, epoch, index), the same functions as the JAX package's, so the
    same seed gives the same order and the same samples, in the calling
    process or in a worker;
  * `drop_last=False` pads the tail batch to the fixed shape by cyclic
    repetition and says in `"__valid__"` how many leading rows are real;
  * `num_workers > 0`: samples are made in worker processes, `prefetch`
    batches ahead, so that augmentation overlaps the device's step. The
    workers are spawned, never forked (the calling process may hold a CUDA
    context and threads), receive the dataset once through the pool's
    initializer, and import only `butd_detr_tpu_torch.data` and what the
    dataset's pickle names.
"""

from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterator, List

import numpy as np

# keys that stay python lists (strings / scalars for the evaluator)
_META_KEYS = ("scan_ids", "utterances", "relation", "target_name")


def collate(samples: List[Dict]) -> Dict:
    """Stack a list of fixed-shape sample dicts into a batch dict; int64
    arrays are emitted as int32 (half the bytes to the device; no index of
    a batch needs more)."""
    out = {}
    for k in samples[0]:
        if k in _META_KEYS:
            out[k] = [s[k] for s in samples]
        else:
            v = np.stack([np.asarray(s[k]) for s in samples])
            if v.dtype == np.int64:
                v = v.astype(np.int32)
            out[k] = v
    return out


# the dataset of a worker process, set once by the pool's initializer
_WORKER_DS = None


def _worker_init(dataset):
    global _WORKER_DS
    _WORKER_DS = dataset


def _worker_get(args):
    index, seed = args
    return _WORKER_DS.get(index, np.random.RandomState(seed))


class DataLoader:
    """Iterates seeded, sharded, fixed-shape batches of a map-style dataset
    (anything with __len__ and get(index, rng)). `close()` stops the
    workers."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_workers: int = 0,
                 prefetch: int = 2, process_index: int = 0,
                 process_count: int = 1, dp_index: int = 0,
                 dp_size: int = 1):
        if batch_size % dp_size:
            raise ValueError(f"--batch_size {batch_size} does not split "
                             f"over --dp {dp_size}")
        self.dataset = dataset
        self.batch_size = batch_size  # per-process batch, all dp shards
        self.dp_index = dp_index
        self.dp_size = dp_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self._pool = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.process_count
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(
                (self.seed * 1_000_003 + self.epoch) % (2**31)
            ).shuffle(order)
        # contiguous shard per process (same count everywhere)
        per = n // self.process_count
        return order[self.process_index * per:(self.process_index + 1) * per]

    def _sample_seed(self, index: int) -> int:
        return int((self.seed * 2_000_003 + self.epoch * 1_000_003 + index)
                   % (2**31))

    @property
    def shard_size(self) -> int:
        """The rows of a batch that this dp shard makes."""
        return self.batch_size // self.dp_size

    def batch_indices(self):
        """[(indices (shard_size,), valid)] of this epoch: a short tail is
        padded by cyclic repetition (torch's DistributedSampler pads the
        same way) and `valid` counts the whole batch's real leading rows
        (the dp shards' rows concatenated)."""
        idx = self._indices()
        per, lo = self.shard_size, self.dp_index * self.shard_size
        out = []
        for i in range(len(self)):
            b = idx[i * self.batch_size:(i + 1) * self.batch_size]
            valid = len(b)
            if valid < self.batch_size:
                b = np.resize(b, self.batch_size)
            out.append((b[lo:lo + per], valid))
        return out

    def _get_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            import multiprocessing as mp

            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers, initializer=_worker_init,
                initargs=(self.dataset,),
                mp_context=mp.get_context("spawn"))
        return self._pool

    def _samples(self, batches) -> Iterator[List[Dict]]:
        """Each batch's samples, in order: made here, or by the workers
        with at most `prefetch` batches in flight."""
        if self.num_workers == 0:
            for b in batches:
                yield [self.dataset.get(
                    int(i), np.random.RandomState(self._sample_seed(int(i))))
                    for i in b]
            return
        pool = self._get_pool()
        pending, inflight = list(batches), []
        while pending or inflight:
            while pending and len(inflight) < self.prefetch:
                inflight.append([
                    pool.submit(_worker_get,
                                (int(i), self._sample_seed(int(i))))
                    for i in pending.pop(0)])
            yield [f.result() for f in inflight.pop(0)]

    def __iter__(self) -> Iterator[Dict]:
        plan = self.batch_indices()
        for (_, valid), samples in zip(
                plan, self._samples([b for b, _ in plan])):
            batch = collate(samples)
            if valid < self.batch_size:
                batch["__valid__"] = valid
            yield batch

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
