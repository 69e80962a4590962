"""Batched host loader with the reference's augmentation — the port's
copy of ``tpudp/data/loader.py``, both backends.

  train: RandomCrop(32, padding=4) -> RandomHorizontalFlip -> ToTensor ->
         Normalize(CIFAR10_MEAN, CIFAR10_STD)
  test:  ToTensor -> Normalize

``mean``, ``std`` and ``pad`` default to CIFAR-10's; ImageNet-geometry
sets pass their own.  Batches are NHWC float32 numpy arrays, equal byte
for byte to the JAX package's at equal seed.  The crop offsets and flips
are drawn in Python from one ``np.random.default_rng((seed, epoch,
shard))`` stream in the JAX loader's order, so the backend never changes
a byte: ``'native'`` runs the fused C++/OpenMP kernels of
``tpudp_torch.native`` (gather, then crop-flip-normalize), ``'numpy'``
the vectorized numpy below, and ``'auto'`` resolves as JAX's does —
native when the library builds, else numpy (the build error stays in
:attr:`DataLoader.native_error`).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from tpudp_torch import native
from tpudp_torch.data.cifar10 import CIFAR10_MEAN, CIFAR10_STD, Dataset
from tpudp_torch.data.sampler import ShardedSampler


def normalize_batch(images_u8: np.ndarray, mean: np.ndarray = CIFAR10_MEAN,
                    std: np.ndarray = CIFAR10_STD) -> np.ndarray:
    """uint8 (B,H,W,3) -> normalized float32, the ToTensor+Normalize pair."""
    x = images_u8.astype(np.float32) / 255.0
    return (x - mean) / std


def draw_augment_params(b: int, rng: np.random.Generator, *,
                        crop_range: int = 9
                        ) -> tuple[np.ndarray, np.ndarray]:
    """The per-sample random decisions, in the JAX loader's order: crop
    offsets ``(B, 2)`` int32 in ``[0, crop_range)`` (``2 * pad + 1``:
    9 for CIFAR's pad 4), then flips ``(B,)``."""
    offsets = rng.integers(0, crop_range, size=(b, 2)).astype(np.int32)
    flips = rng.random(b) < 0.5
    return offsets, flips


def apply_crop_flip(images_u8: np.ndarray, offsets: np.ndarray,
                    flips: np.ndarray, *, pad: int = 4) -> np.ndarray:
    """numpy backend: zero-pad by ``pad``, crop (H, W) at ``offsets``,
    flip where set."""
    b, h, w, _ = images_u8.shape
    padded = np.pad(images_u8, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    rows = offsets[:, 0, None] + np.arange(h)  # (B, H)
    cols = offsets[:, 1, None] + np.arange(w)
    out = padded[np.arange(b)[:, None, None], rows[:, :, None],
                 cols[:, None, :]]
    out[flips] = out[flips, :, ::-1]
    return out


def resolve_backend(backend: str) -> str:
    """``'native'`` or ``'numpy'`` for a requested backend: ``'auto'`` is
    native when the library builds and loads; ``'native'`` raises with
    the build error when it does not."""
    if backend == "auto":
        return "native" if native.available() else "numpy"
    if backend == "native" and not native.available():
        raise RuntimeError(f"native backend requested but the C++ library "
                           f"failed to build or load: "
                           f"{native.load_error()}")
    if backend not in ("native", "numpy"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


class DataLoader:
    """Iterates ``(images, labels, weights)`` numpy batches over a shard.

    ``batch_size`` is this process's batch (the global batch over the
    world size).  ``drop_last`` defaults to ``train``: training drops a
    ragged final batch, evaluation pads it and weights the padding 0.
    :attr:`backend` is the resolved backend, ``'native'`` or
    ``'numpy'``; :attr:`native_error` is why ``'auto'`` resolved to
    numpy (None otherwise).
    """

    def __init__(self, dataset: Dataset, batch_size: int, *,
                 sampler: ShardedSampler | None = None, train: bool = True,
                 seed: int = 0, drop_last: bool | None = None,
                 backend: str = "auto", mean: np.ndarray | None = None,
                 std: np.ndarray | None = None, pad: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.mean = np.asarray(CIFAR10_MEAN if mean is None else mean,
                               np.float32)
        self.std = np.asarray(CIFAR10_STD if std is None else std,
                              np.float32)
        self.pad = pad
        self.sampler = sampler or ShardedSampler(len(dataset.images),
                                                 shuffle=train, seed=seed)
        self.train = train
        self.seed = seed
        self.drop_last = train if drop_last is None else drop_last
        self.epoch = 0
        self.backend = resolve_backend(backend)
        self.native_error = (native.load_error()
                             if self.backend == "numpy" and backend == "auto"
                             else None)

    def banner(self) -> str:
        """The resolved backend for a run's banner; where ``'auto'`` fell
        back to numpy, with the native build's error on the same line."""
        if self.native_error is None:
            return self.backend
        return (f"{self.backend} (native unavailable: "
                f"{' '.join(self.native_error.split())})")

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
        use_native = self.backend == "native"
        for b in range(len(self)):
            rows = slice(b * self.batch_size, (b + 1) * self.batch_size)
            sel = idx[rows]
            if use_native:
                images = native.gather(self.dataset.images, sel)
            else:
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
                offsets, flips = draw_augment_params(
                    len(images), aug_rng, crop_range=2 * self.pad + 1)
                if use_native:
                    images = native.augment_normalize(
                        images, offsets, flips, self.mean, self.std,
                        pad=self.pad)
                else:
                    images = normalize_batch(
                        apply_crop_flip(images, offsets, flips,
                                        pad=self.pad), self.mean, self.std)
            elif use_native:
                images = native.normalize(images, self.mean, self.std)
            else:
                images = normalize_batch(images, self.mean, self.std)
            yield images, labels.astype(np.int32), weights
