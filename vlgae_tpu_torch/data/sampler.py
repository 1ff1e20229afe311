"""Length-bucketed token-budget batch samplers.

A copy of ``vlgae_tpu/data/sampler.py``. Every batch reports a
``pad_len`` equal to its bucket's max length rounded up to a multiple of
``len_round``; the rounding and the bucketing decide which sentences
share a batch, so they are kept exactly as in the reference package.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


def kmeans_1d(x: Sequence[int], k: int, max_it: int = 32):
    """1-D k-means over lengths (ref: sampler.py:147-191, numpy re-design).

    Returns (centroids, clusters) where clusters are index lists.
    """
    x = np.asarray(x, dtype=np.float64)
    uniq = np.unique(x)
    k = min(len(uniq), k)
    rng = np.random.default_rng(0)
    c = rng.permutation(uniq)[:k]
    y = np.abs(x[:, None] - c[None, :]).argmin(-1)
    for _ in range(max_it):
        dists = np.abs(x[:, None] - c[None, :])
        y = dists.argmin(-1)
        # re-seed empty clusters with the farthest point of the biggest
        counts = np.bincount(y, minlength=k)
        while (counts == 0).any():
            empty = int(np.where(counts == 0)[0][0])
            big = int(counts.argmax())
            members = np.where(y == big)[0]
            far = members[np.abs(x[members] - c[big]).argmax()]
            y[far] = empty
            counts = np.bincount(y, minlength=k)
        old = c.copy()
        for i in range(k):
            c[i] = x[y == i].mean()
        if np.allclose(c, old):
            break
    assigned = np.unique(y)
    centroids = [float(c[i]) for i in assigned]
    clusters = [np.where(y == i)[0].tolist() for i in assigned]
    return centroids, clusters


class ConstantTokenNumSampler:
    """Token-budget batches from length buckets (ref: sampler.py:15-191)."""

    def __init__(self, seq_len: Sequence[int], max_token: int = 4096,
                 max_sentence: int = -1, num_bucket: int = 16,
                 single_sent_threshold: int = -1, sort_in_batch: bool = True,
                 shuffle: bool = True, force_same_len: bool = False,
                 len_round: int = 8):
        assert num_bucket > 1 or force_same_len
        self.seq_len = list(seq_len)
        self.max_token = max_token
        self.max_sentence = max_sentence if max_sentence > 0 else 10 ** 16
        self.single_sent_threshold = single_sent_threshold
        self.sort_in_batch = sort_in_batch and not force_same_len
        self.shuffle = shuffle
        self.len_round = len_round
        self.epoch = 0

        if force_same_len:
            sizes = sorted(set(self.seq_len))
            len2idx = {l: i for i, l in enumerate(sizes)}
            buckets: List[List[int]] = [[] for _ in sizes]
            for i, l in enumerate(self.seq_len):
                buckets[len2idx[l]].append(i)
            self.sizes, self.buckets = sizes, buckets
        else:
            self.sizes, self.buckets = kmeans_1d(
                self.seq_len, min(num_bucket, len(self.seq_len))
            )

        self.chunks = [
            min(
                len(bucket),
                max(
                    math.ceil(size * len(bucket) / max_token),
                    math.ceil(len(bucket) / self.max_sentence),
                ),
            )
            for size, bucket in zip(self.sizes, self.buckets)
        ]
        self._batches: List[List[int]] = []
        self._refresh()

    def _refresh(self):
        if self.shuffle:
            self.epoch += 1
            rng = np.random.default_rng(self.epoch)
            perm = rng.permutation
        else:
            perm = np.arange

        batches = []
        for i, bucket in enumerate(self.buckets):
            order = perm(len(bucket))
            n_chunk = self.chunks[i]
            split_sizes = [
                (len(bucket) - j - 1) // n_chunk + 1 for j in range(n_chunk)
            ]
            start = 0
            for size in split_sizes:
                sel = order[start:start + size]
                batches.append([bucket[j] for j in sel])
                start += size
        batches = [
            b
            for i in perm(len(batches))
            for b in self._process_batch(list(batches[i]))
        ]
        self._batches = [b for b in batches if b]

    def _process_batch(self, batch):
        singles = []
        if self.single_sent_threshold != -1:
            kept = []
            for i in batch:
                (singles if self.seq_len[i] >= self.single_sent_threshold
                 else kept).append(i)
            singles = [[i] for i in singles]
            batch = kept
        if self.sort_in_batch:
            batch.sort(key=lambda i: -self.seq_len[i])
        return ([batch] if batch else []) + singles

    def pad_len(self, batch: List[int]) -> int:
        m = max(self.seq_len[i] for i in batch)
        r = self.len_round
        return max(r, (m + r - 1) // r * r)

    def __iter__(self):
        out = self._batches
        self._refresh()
        yield from out

    def set_epoch(self, epoch: int) -> None:
        """Restore the state after ``epoch`` reshuffles (see ``_refresh``)."""
        if self.shuffle:
            self.epoch = epoch - 1
            self._refresh()

    def __len__(self):
        return len(self._batches)


class BasicSampler:
    """Plain (optionally shuffled) fixed-size batches (ref: sampler.py:194-248)."""

    def __init__(self, seq_len, batch_size, single_sent_threshold=-1,
                 sort_in_batch=True, shuffle=True, len_round: int = 8):
        self.seq_len = list(seq_len)
        self.batch_size = batch_size
        self.single_sent_threshold = single_sent_threshold
        self.sort_in_batch = sort_in_batch
        self.shuffle = shuffle
        self.len_round = len_round
        self.epoch = 0

    def pad_len(self, batch):
        m = max(self.seq_len[i] for i in batch)
        r = self.len_round
        return max(r, (m + r - 1) // r * r)

    def __iter__(self):
        self.epoch += 1
        if self.shuffle:
            order = np.random.default_rng(self.epoch).permutation(
                len(self.seq_len)
            )
        else:
            order = np.arange(len(self.seq_len))
        batch = []
        for i in order:
            batch.append(int(i))
            if len(batch) == self.batch_size:
                yield from self._process_batch(batch)
                batch = []
        if batch:
            yield from self._process_batch(batch)

    def __len__(self):
        return math.ceil(len(self.seq_len) / self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Restore the state after ``epoch`` iterations."""
        self.epoch = epoch

    def _process_batch(self, batch):
        singles = []
        if self.single_sent_threshold != -1:
            kept = []
            for i in batch:
                (singles if self.seq_len[i] >= self.single_sent_threshold
                 else kept).append(i)
            singles = [[i] for i in singles]
            batch = kept
        if self.sort_in_batch:
            batch.sort(key=lambda i: -self.seq_len[i])
        return ([batch] if batch else []) + singles
