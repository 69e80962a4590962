"""The reference's CIFAR-10 training batches in plain NumPy.

``DistributedSampler``'s order at one shard (a permutation drawn from
``seed + epoch``), then for each batch, in order, crop origins and flips
drawn from one ``default_rng((seed, epoch, 0))`` stream: ``RandomCrop(32,
padding=4)``, ``RandomHorizontalFlip``, ``ToTensor`` and ``Normalize``.
"""

from __future__ import annotations

import numpy as np


def batches(images_u8: np.ndarray, labels: np.ndarray, seed: int,
            epoch: int, batch: int, count: int, aug: dict) -> list:
    """The first ``count`` ``(images float32 NHWC, labels)`` batches of
    ``epoch``."""
    pad = aug["pad"]
    scale = np.float32(aug["scale"])
    mean = np.asarray(aug["mean"], np.float32) / scale
    std = np.asarray(aug["std"], np.float32) / scale
    order = np.random.default_rng(seed + epoch).permutation(len(images_u8))
    rng = np.random.default_rng((seed, epoch, 0))
    out = []
    for b in range(count):
        sel = order[b * batch:(b + 1) * batch]
        offsets = rng.integers(0, 2 * pad + 1, size=(batch, 2))
        flips = rng.random(batch) < 0.5
        imgs = np.pad(images_u8[sel], ((0, 0), (pad, pad), (pad, pad),
                                       (0, 0)))
        h, w = images_u8.shape[1:3]
        crops = np.stack([imgs[i, r:r + h, c:c + w]
                          for i, (r, c) in enumerate(offsets)])
        crops[flips] = crops[flips, :, ::-1]
        x = (crops.astype(np.float32) / scale - mean) / std
        out.append((x, labels[sel]))
    return out
