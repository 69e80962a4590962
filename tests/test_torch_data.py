"""The port's data pipeline (``tpudp_torch.data``) against the JAX
package's: the same synthetic and on-disk CIFAR-10 sets, sampler indices
and masks, and loader batches, byte for byte at equal seed; the
prefetcher's order, content and device placement."""

import os
import pickle
import tarfile
import threading
import time

import numpy as np
import pytest
import torch

from tpudp.data import cifar10 as jax_cifar10
from tpudp.data import loader as jax_loader
from tpudp.data.sampler import ShardedSampler as JaxSampler
from tpudp_torch.data import (DataLoader, Prefetcher, ShardedSampler,
                              cifar10, device_place, loader)


def _same_dataset(a, b):
    assert a.images.dtype == b.images.dtype == np.uint8
    assert a.labels.dtype == b.labels.dtype == np.int32
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)


def test_synthetic_sets_equal_jax(tmp_path):
    """No dataset on disk: the synthetic train and test sets are JAX's,
    byte for byte."""
    got = cifar10.load_cifar10(str(tmp_path), synthetic_train_size=300,
                               synthetic_test_size=70)
    want = jax_cifar10.load_cifar10(str(tmp_path), download=False,
                                    synthetic_train_size=300,
                                    synthetic_test_size=70)
    assert got[2] is want[2] is True
    _same_dataset(got[0], want[0])
    _same_dataset(got[1], want[1])
    assert got[0].images.shape == (300, 32, 32, 3)
    np.testing.assert_array_equal(cifar10.CIFAR10_MEAN,
                                  jax_cifar10.CIFAR10_MEAN)
    np.testing.assert_array_equal(cifar10.CIFAR10_STD,
                                  jax_cifar10.CIFAR10_STD)
    with pytest.raises(FileNotFoundError):
        cifar10.load_cifar10(str(tmp_path), synthetic_fallback=False)


def _write_batches(batch_dir, rng):
    os.makedirs(batch_dir)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        entry = {"data": rng.integers(0, 256, size=(7, 3072), dtype=np.uint8),
                 "labels": rng.integers(0, 10, size=7).tolist()}
        with open(os.path.join(batch_dir, name), "wb") as f:
            pickle.dump(entry, f)


@pytest.mark.parametrize("packed", [False, True], ids=["dir", "tarball"])
def test_pickle_batches_read_as_jax_reads_them(tmp_path, packed):
    """The on-disk format (pickle batches, or their tarball) reads into
    the same NHWC images and labels as JAX's reader."""
    rng = np.random.default_rng(0)
    src = tmp_path / "src"
    _write_batches(src / "cifar-10-batches-py", rng)
    roots = []
    for who in ("port", "jax"):
        root = tmp_path / who
        if packed:
            root.mkdir()
            with tarfile.open(root / "cifar-10-python.tar.gz", "w:gz") as t:
                t.add(src / "cifar-10-batches-py", "cifar-10-batches-py")
        else:
            _write_batches(root / "cifar-10-batches-py",
                           np.random.default_rng(0))
        roots.append(str(root))
    got = cifar10.load_cifar10(roots[0])
    want = jax_cifar10.load_cifar10(roots[1], download=False)
    assert got[2] is want[2] is False
    assert got[0].images.shape == (35, 32, 32, 3)
    _same_dataset(got[0], want[0])
    _same_dataset(got[1], want[1])


SAMPLER_CASES = [
    dict(dataset_size=103, num_shards=4, shuffle=True, seed=7),
    dict(dataset_size=100, num_shards=2, shuffle=True, seed=0),
    dict(dataset_size=43, num_shards=2, shuffle=False),
    dict(dataset_size=48, num_shards=1, shuffle=True, seed=3),
    dict(dataset_size=10, num_shards=3, shuffle=False),
    # the reference's order: the same shuffle every epoch
    dict(dataset_size=103, num_shards=4, shuffle=True, seed=7,
         reshuffle_each_epoch=False),
    dict(dataset_size=10, num_shards=3, shuffle=False,
         reshuffle_each_epoch=False),
]


@pytest.mark.parametrize("case", range(len(SAMPLER_CASES)))
def test_sampler_matches_jax(case):
    """Indices and validity masks per (epoch, shard) equal JAX's."""
    kw = dict(SAMPLER_CASES[case])
    n, shards = kw.pop("dataset_size"), kw.pop("num_shards")
    for shard in range(shards):
        got = ShardedSampler(n, shards, shard, **kw)
        want = JaxSampler(n, shards, shard, **kw)
        assert len(got) == len(want)
        for epoch in (0, 1, 2):
            for a, b in zip(got.indices_and_mask(epoch),
                            want.indices_and_mask(epoch)):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        ShardedSampler(n, shards, shards)


def test_sampler_batch_contiguous_is_refused_by_name():
    """``batch_contiguous`` (once refused) is JAX's layout: every shard's
    indices and masks equal JAX's per epoch, the shards of one global
    batch assemble the same rows at any shard count (the elastic
    relaunch's property), and JAX's two ValueErrors are raised alike."""
    ShardedSampler(64, 2, 1, batch_contiguous=None)
    for n, shards, batch in ((64, 2, 16), (64, 4, 16), (60, 3, 12),
                             (48, 3, 12), (48, 2, 12)):
        for shard in range(shards):
            got = ShardedSampler(n, shards, shard, seed=5,
                                 batch_contiguous=batch)
            want = JaxSampler(n, shards, shard, seed=5,
                              batch_contiguous=batch)
            for epoch in (0, 1):
                for a, b in zip(got.indices_and_mask(epoch),
                                want.indices_and_mask(epoch)):
                    np.testing.assert_array_equal(a, b)
    def global_rows(shards, epoch=1):  # noqa: E306
        parts = [ShardedSampler(48, shards, k, seed=5, batch_contiguous=12)
                 .indices(epoch).reshape(-1, 12 // shards)
                 for k in range(shards)]
        return np.concatenate(parts, axis=1)
    np.testing.assert_array_equal(global_rows(3), global_rows(2))
    for args, kw in (((64, 3, 0), {"batch_contiguous": 16}),
                     ((60, 2, 0), {"batch_contiguous": 16})):
        for cls in (ShardedSampler, JaxSampler):
            with pytest.raises(ValueError, match="batch_contiguous|global "
                               "batches"):
                cls(*args, **kw)
    fixed = ShardedSampler(20, 1, 0, reshuffle_each_epoch=False)
    np.testing.assert_array_equal(fixed.indices(0), fixed.indices(5))


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return cifar10.Dataset(
        rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, size=n).astype(np.int32))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_loader_batches_equal_jax_over_epochs_and_shards(train):
    """Two epochs, two shards, a ragged set (eval pads its last batch and
    weights the padding and the wrap-around duplicate 0): every batch's
    images, labels and weights equal JAX's numpy backend's, byte for
    byte, augmentation draws included."""
    data = _images(45)
    for shard in range(2):
        kw = dict(shuffle=train, seed=5)
        got = DataLoader(data, 8, sampler=ShardedSampler(45, 2, shard, **kw),
                         train=train, seed=5)
        want = jax_loader.DataLoader(
            data, 8, sampler=JaxSampler(45, 2, shard, **kw), train=train,
            seed=5, backend="numpy")
        assert len(got) == len(want) == (2 if train else 3)
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            pairs = list(zip(got, want, strict=True))
            for g, w in pairs:
                for a, b in zip(g, w):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
            if not train:
                assert pairs[-1][0][2].sum() < 8  # padding weighs 0


def test_augment_and_normalize_equal_jax():
    imgs = _images(16, seed=3).images
    ours = loader.draw_augment_params(16, np.random.default_rng(1))
    theirs = jax_loader.draw_augment_params(16, np.random.default_rng(1))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(loader.apply_crop_flip(imgs, *ours),
                                  jax_loader.apply_crop_flip(imgs, *theirs))
    np.testing.assert_array_equal(
        loader.apply_crop_flip(imgs, *ours),
        jax_loader.augment_batch(imgs, np.random.default_rng(1)))
    np.testing.assert_array_equal(loader.normalize_batch(imgs),
                                  jax_loader.normalize_batch(imgs))


def test_loader_backends_resolve_as_jax():
    """``'native'`` and ``'auto'`` run the C++ backend (it builds here),
    ``'numpy'`` the numpy path, with the same bytes
    (tests/test_torch_native.py holds both to JAX's loaders)."""
    native = DataLoader(_images(8), 4, backend="native")
    auto = DataLoader(_images(8), 4)
    numpy = DataLoader(_images(8), 4, backend="numpy")
    assert (native.backend, auto.backend, numpy.backend) == (
        "native", "native", "numpy")
    for a, b in zip(native, numpy):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        DataLoader(_images(8), 4, backend="fast")


def _no_live_workers(deadline_s=5.0):
    """True once no prefetch worker thread is alive (within the deadline:
    a stopped worker leaves at its next 0.1 s queue poll)."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if not any(t.name == "tpudp-prefetch" and t.is_alive()
                   for t in threading.enumerate()):
            return True
        time.sleep(0.05)
    return False


def test_prefetcher_keeps_order_and_places_on_the_device():
    """Batches come through in the loader's order and content; the place
    hook runs on the worker thread and turns them into tensors (on the
    CPU, views of the numpy arrays)."""
    data = _images(40)
    base = DataLoader(data, 8, train=True, seed=2)
    want = list(base)
    seen = set()
    place = device_place("cpu")

    def hook(batch):
        seen.add(threading.current_thread().name)
        return place(batch)

    pf = Prefetcher(DataLoader(data, 8, train=True, seed=2), depth=2,
                    place=hook)
    got = list(pf)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), b)
    assert seen == {"tpudp-prefetch"}
    pf.close()
    assert _no_live_workers()


def test_prefetcher_propagates_errors_and_stops_early():
    def broken():
        yield 1
        raise RuntimeError("loader failed")

    class Loader:
        def __iter__(self):
            return broken()

        def __len__(self):
            return 2

    with pytest.raises(RuntimeError, match="loader failed"):
        list(Prefetcher(Loader()))
    pf = Prefetcher(DataLoader(_images(80), 8), depth=1)
    for _ in pf:
        break
    pf.close()
    assert _no_live_workers()
    with pytest.raises(ValueError):
        Prefetcher(Loader(), depth=0)
