"""Batched host loader with the reference's augmentation, vectorized in
numpy — the port's copy of ``tpudp/data/loader.py``'s numpy backend.

  train: RandomCrop(32, padding=4) -> RandomHorizontalFlip -> ToTensor ->
         Normalize(CIFAR10_MEAN, CIFAR10_STD)
  test:  ToTensor -> Normalize

Batches are NHWC float32 numpy arrays, equal byte for byte to the JAX
package's at equal seed: the crop offsets and flips are drawn from the
same ``np.random.default_rng((seed, epoch, shard))`` stream in the same
order.  The JAX package's native C++ backend is not ported
(``backend='native'`` raises; ``'auto'`` is numpy).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from tpudp_torch.data.cifar10 import CIFAR10_MEAN, CIFAR10_STD, Dataset
from tpudp_torch.data.sampler import ShardedSampler


PAD = 4  # RandomCrop(32, padding=4)


def normalize_batch(images_u8: np.ndarray) -> np.ndarray:
    """uint8 (B,H,W,3) -> normalized float32, the ToTensor+Normalize pair."""
    x = images_u8.astype(np.float32) / 255.0
    return (x - CIFAR10_MEAN) / CIFAR10_STD


def draw_augment_params(b: int, rng: np.random.Generator
                        ) -> tuple[np.ndarray, np.ndarray]:
    """The per-sample random decisions, in the JAX loader's order: crop
    offsets ``(B, 2)`` int32 in ``[0, 2 * PAD]``, then flips ``(B,)``."""
    offsets = rng.integers(0, 2 * PAD + 1, size=(b, 2)).astype(np.int32)
    flips = rng.random(b) < 0.5
    return offsets, flips


def apply_crop_flip(images_u8: np.ndarray, offsets: np.ndarray,
                    flips: np.ndarray) -> np.ndarray:
    """Zero-pad by ``PAD``, crop (H, W) at ``offsets``, flip where set."""
    b, h, w, _ = images_u8.shape
    padded = np.pad(images_u8, ((0, 0), (PAD, PAD), (PAD, PAD), (0, 0)))
    rows = offsets[:, 0, None] + np.arange(h)  # (B, H)
    cols = offsets[:, 1, None] + np.arange(w)
    out = padded[np.arange(b)[:, None, None], rows[:, :, None],
                 cols[:, None, :]]
    out[flips] = out[flips, :, ::-1]
    return out


class DataLoader:
    """Iterates ``(images, labels, weights)`` numpy batches over a shard.

    ``batch_size`` is this process's batch (the global batch over the
    world size).  ``drop_last`` defaults to ``train``: training drops a
    ragged final batch, evaluation pads it and weights the padding 0.
    """

    def __init__(self, dataset: Dataset, batch_size: int, *,
                 sampler: ShardedSampler | None = None, train: bool = True,
                 seed: int = 0, drop_last: bool | None = None,
                 backend: str = "auto"):
        if backend == "native":
            raise NotImplementedError(
                "the native augment backend is not ported yet: ROADMAP.md "
                "slice 7c (native augment backend)")
        if backend not in ("auto", "numpy"):
            raise ValueError(f"unknown backend {backend!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(len(dataset.images),
                                                 shuffle=train, seed=seed)
        self.train = train
        self.seed = seed
        self.drop_last = train if drop_last is None else drop_last
        self.epoch = 0
        self.backend = "numpy"

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.sampler)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray,
                                         np.ndarray]]:
        """Yields (images f32 NHWC, labels i32, weights f32); ``weights``
        is 1 for real samples, 0 for the padding of a ragged eval batch
        and for wrap-around duplicates in evaluation."""
        idx, valid = self.sampler.indices_and_mask(self.epoch)
        aug_rng = np.random.default_rng((self.seed, self.epoch,
                                         self.sampler.shard_index))
        for b in range(len(self)):
            rows = slice(b * self.batch_size, (b + 1) * self.batch_size)
            sel = idx[rows]
            images = self.dataset.images[sel]
            labels = self.dataset.labels[sel]
            if self.train:  # DistributedSampler: duplicates count
                weights = np.ones(len(sel), dtype=np.float32)
            else:
                weights = valid[rows].astype(np.float32)
            if len(sel) < self.batch_size:  # pad a ragged eval batch
                pad = self.batch_size - len(sel)
                images = np.concatenate(
                    [images, np.zeros((pad, *images.shape[1:]),
                                      images.dtype)])
                labels = np.concatenate([labels, np.zeros(pad,
                                                          labels.dtype)])
                weights = np.concatenate([weights,
                                          np.zeros(pad, np.float32)])
            if self.train:
                offsets, flips = draw_augment_params(len(images), aug_rng)
                images = normalize_batch(apply_crop_flip(images, offsets,
                                                         flips))
            else:
                images = normalize_batch(images)
            yield images, labels.astype(np.int32), weights
