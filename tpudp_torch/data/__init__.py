"""The port's host data pipeline: CIFAR-10 (real or synthetic), the
reference's augmentation (the native C++/OpenMP backend or numpy) and
per-shard sampling, and prefetching onto a device."""

from tpudp_torch.data.cifar10 import (CIFAR10_MEAN, CIFAR10_STD,  # noqa: F401
                                      load_cifar10)
from tpudp_torch.data.loader import DataLoader, normalize_batch  # noqa: F401
from tpudp_torch.data.prefetch import Prefetcher, device_place  # noqa: F401
from tpudp_torch.data.sampler import ShardedSampler  # noqa: F401
