"""Batched data loader (host side).

Counterpart of `butd_detr_tpu/data/loader.py` (which replaces the
reference's torch DataLoader + DistributedSampler, main_utils.py:197-233):

  * fixed-shape numpy batches (every sample is already padded);
  * a contiguous shard of the (shuffled) index order per process;
  * deterministic seeding: shuffle = f(seed, epoch), sample rng =
    f(seed, epoch, index), the same functions as the JAX package's, so the
    same seed gives the same order and the same per-sample seeds;
  * `drop_last=False` pads the tail batch to the fixed shape by cyclic
    repetition and says in `"__valid__"` how many leading rows are real.

Samples are loaded in the calling process. Worker processes with prefetch
belong to the data slice (ROADMAP queue 1, "Data"): `num_workers` other
than 0 raises.
"""

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


class DataLoader:
    """Iterates seeded, sharded, fixed-shape batches of a map-style dataset
    (anything with __len__ and get(index, rng))."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_workers: int = 0,
                 process_index: int = 0, process_count: int = 1):
        if num_workers != 0:
            raise NotImplementedError(
                "worker processes belong to the port's data slice (ROADMAP "
                "queue 1, 'Data'); pass num_workers=0")
        self.dataset = dataset
        self.batch_size = batch_size  # per-process batch
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

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

    def batch_indices(self):
        """[(indices (batch_size,), valid)] of this epoch: a short tail is
        padded by cyclic repetition (torch's DistributedSampler pads the
        same way) and `valid` counts its real leading rows."""
        idx = self._indices()
        out = []
        for i in range(len(self)):
            b = idx[i * self.batch_size:(i + 1) * self.batch_size]
            valid = len(b)
            if valid < self.batch_size:
                b = np.resize(b, self.batch_size)
            out.append((b, valid))
        return out

    def __iter__(self) -> Iterator[Dict]:
        for b, valid in self.batch_indices():
            batch = collate([
                self.dataset.get(
                    int(i), np.random.RandomState(self._sample_seed(int(i))))
                for i in b])
            if valid < self.batch_size:
                batch["__valid__"] = valid
            yield batch
