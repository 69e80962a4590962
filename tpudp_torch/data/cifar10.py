"""CIFAR-10 for the port — its own copy of ``tpudp/data/cifar10.py``.

Reads the ``cifar-10-batches-py`` pickle batches (or their tarball) from
``root`` when they are there.  Otherwise it returns the JAX package's
deterministic, learnable synthetic stand-in (each class a fixed random
template plus noise), byte for byte: the same numpy draws from the same
seeds.  Unlike the JAX package it never downloads (ROADMAP.md,
documented divergences): the card's machine has no network.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from typing import NamedTuple

import numpy as np

# The reference's Normalize constants (mean and std of each channel).
CIFAR10_MEAN = np.array([125.3, 123.0, 113.9], dtype=np.float32) / 255.0
CIFAR10_STD = np.array([63.0, 62.1, 66.7], dtype=np.float32) / 255.0

_TRAIN_BATCHES = [f"data_batch_{i}" for i in range(1, 6)]
_TEST_BATCHES = ["test_batch"]


class Dataset(NamedTuple):
    images: np.ndarray  # (N, 32, 32, 3) uint8, NHWC
    labels: np.ndarray  # (N,) int32


def _read_pickle_batches(batch_dir: str, names: list[str]) -> Dataset:
    images, labels = [], []
    for name in names:
        with open(os.path.join(batch_dir, name), "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        data = np.asarray(entry["data"], dtype=np.uint8)
        images.append(data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.append(np.asarray(entry.get("labels", entry.get("fine_labels")),
                                 dtype=np.int32))
    return Dataset(np.concatenate(images), np.concatenate(labels))


def _maybe_extract(root: str) -> str | None:
    batch_dir = os.path.join(root, "cifar-10-batches-py")
    if os.path.isdir(batch_dir):
        return batch_dir
    tgz = os.path.join(root, "cifar-10-python.tar.gz")
    if os.path.isfile(tgz):
        with tarfile.open(tgz, "r:gz") as tar:
            tar.extractall(root, filter="data")
        if os.path.isdir(batch_dir):
            return batch_dir
    return None


def _synthetic(n: int, seed: int, num_classes: int = 10) -> Dataset:
    """Deterministic class-conditional images: template[label] + noise."""
    rng = np.random.default_rng(seed)
    templates = rng.integers(0, 256, size=(num_classes, 32, 32, 3))
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    noise = rng.normal(0.0, 48.0, size=(n, 32, 32, 3))
    images = np.clip(templates[labels] + noise, 0, 255).astype(np.uint8)
    return Dataset(images, labels)


def load_cifar10(
    root: str = "./data",
    *,
    synthetic_fallback: bool = True,
    synthetic_train_size: int = 50_000,
    synthetic_test_size: int = 10_000,
) -> tuple[Dataset, Dataset, bool]:
    """Return ``(train, test, is_synthetic)``: the pickle batches under
    ``root`` when present, else the synthetic stand-in (or
    ``FileNotFoundError`` with ``synthetic_fallback=False``)."""
    batch_dir = _maybe_extract(root)
    if batch_dir is not None:
        return (_read_pickle_batches(batch_dir, _TRAIN_BATCHES),
                _read_pickle_batches(batch_dir, _TEST_BATCHES), False)
    if not synthetic_fallback:
        raise FileNotFoundError(
            f"CIFAR-10 not found under {root!r} and synthetic_fallback=False")
    # Train and test are disjoint noise draws over the same class
    # templates (the same template stream, another label/noise stream).
    train = _synthetic(synthetic_train_size, seed=1234)
    templates = np.random.default_rng(1234).integers(0, 256,
                                                     size=(10, 32, 32, 3))
    trng = np.random.default_rng(5678)
    labels = trng.integers(0, 10, size=synthetic_test_size).astype(np.int32)
    noise = trng.normal(0.0, 48.0, size=(synthetic_test_size, 32, 32, 3))
    test = Dataset(
        np.clip(templates[labels] + noise, 0, 255).astype(np.uint8), labels)
    return train, test, True
