"""Deterministic shard-aware sampling — the port's copy of
``tpudp/data/sampler.py`` (the reference's ``DistributedSampler``).

Shuffle every index with a numpy generator seeded by ``seed + epoch``,
pad to a multiple of the shard count by wrapping around, then take the
strided slice ``indices[shard::num_shards]``: the same indices and
validity masks as the JAX package's, per (epoch, shard).
``reshuffle_each_epoch=False`` keeps the reference's order, the same
shuffle every epoch (it never calls ``set_epoch``), as JAX's does.

``batch_contiguous`` (a GLOBAL batch size, or None) switches to JAX's
per-batch contiguous layout: shard ``k`` of ``H`` takes rows ``[k*B/H,
(k+1)*B/H)`` of every global batch drawn from the canonical order, so the
assembled global batch is a function of ``(seed, epoch)`` alone, whatever
the number of shards — what a run resumed at another rank count (the
relaunch after an SDC quarantine) needs to continue its trajectory.  The
padded size must be whole global batches, and the batch must split
evenly across the shards.
"""

from __future__ import annotations

import numpy as np


class ShardedSampler:
    """One shard's sample order; see the module docstring."""

    def __init__(self, dataset_size: int, num_shards: int = 1,
                 shard_index: int = 0, *, shuffle: bool = True,
                 seed: int = 0, reshuffle_each_epoch: bool = True,
                 batch_contiguous: int | None = None):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} out of range "
                             f"[0, {num_shards})")
        self.dataset_size = dataset_size
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.shuffle = shuffle
        self.seed = seed
        self.reshuffle_each_epoch = reshuffle_each_epoch
        # Every shard sees the same number of samples (wrap-around pad).
        self.num_samples = -(-dataset_size // num_shards)
        self.total_size = self.num_samples * num_shards
        self.batch_contiguous = batch_contiguous
        if batch_contiguous is not None:
            if batch_contiguous % num_shards:
                raise ValueError(
                    f"batch_contiguous={batch_contiguous} must split evenly "
                    f"across {num_shards} shards")
            if self.total_size % batch_contiguous:
                raise ValueError(
                    f"padded dataset size {self.total_size} is not a whole "
                    f"number of global batches of {batch_contiguous} — the "
                    "contiguous layout has no canonical final batch")

    def indices(self, epoch: int = 0) -> np.ndarray:
        return self.indices_and_mask(epoch)[0]

    def indices_and_mask(self, epoch: int = 0
                         ) -> tuple[np.ndarray, np.ndarray]:
        """``(indices, valid)``: ``valid`` is False for the wrap-around
        padding, which training counts and evaluation weights 0."""
        if self.shuffle:
            seed = self.seed + (epoch if self.reshuffle_each_epoch else 0)
            order = np.random.default_rng(seed).permutation(
                self.dataset_size)
        else:
            order = np.arange(self.dataset_size)
        valid = np.ones(self.total_size, dtype=bool)
        if self.total_size > self.dataset_size:
            pad = self.total_size - self.dataset_size
            order = np.concatenate([order, order[:pad]])
            valid[self.dataset_size:] = False
        if self.batch_contiguous is not None:
            per = self.batch_contiguous // self.num_shards
            lo = self.shard_index * per
            order = order.reshape(-1, self.batch_contiguous)
            valid = valid.reshape(-1, self.batch_contiguous)
            return (order[:, lo:lo + per].reshape(-1),
                    valid[:, lo:lo + per].reshape(-1))
        sel = slice(self.shard_index, None, self.num_shards)
        return order[sel], valid[sel]

    def __len__(self) -> int:
        return self.num_samples
