"""The port's native augment backend (``tpudp_torch.native``, C++/OpenMP
through ctypes) against its numpy path and the JAX package's native and
numpy backends, byte for byte.

The entry points at CIFAR's 32x32 and at a 64x64 stand-in for 224, at
CIFAR's and ImageNet's mean and std and at pads other than 4; the
loader over two shards, two epochs and a ragged final eval batch; the
build: ``'auto'`` resolves to native here (g++ is on the machine), a
failed build is kept and named, and an edited source gets a library of
its own.
"""

import shutil
import threading
import time

import numpy as np
import pytest

from tpudp import native as jax_native
from tpudp.data import loader as jax_loader
from tpudp.data.sampler import ShardedSampler as JaxSampler
from tpudp_torch import native
from tpudp_torch.data import DataLoader, ShardedSampler, cifar10, loader
from tpudp_torch.train_resnet import IMAGENET_MEAN, IMAGENET_STD

IMAGENET = (np.asarray(IMAGENET_MEAN, np.float32),
            np.asarray(IMAGENET_STD, np.float32))
CIFAR = (cifar10.CIFAR10_MEAN, cifar10.CIFAR10_STD)
# (image size, pad, statistics): CIFAR's geometry, then pads other than
# 4 and ImageNet's statistics, at 32 and at a 64x64 stand-in for 224.
GEOMETRIES = {"32-pad4-cifar": (32, 4, CIFAR),
              "32-pad2-imagenet": (32, 2, IMAGENET),
              "64-pad8-imagenet": (64, 8, IMAGENET)}


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """``tpudp.native`` builds its library beside its source at first use,
    unlinking the old file first: a build racing another test process's
    can leave it unloaded once, so load it again after a pause."""
    for _ in range(3):
        if jax_native.load() is not None:
            return
        time.sleep(2)
        jax_native._load_attempted = False
    pytest.fail("tpudp.native's library did not build")


def _images(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return cifar10.Dataset(
        rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8),
        rng.integers(0, 10, size=n).astype(np.int32))


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_entry_points_equal_numpy_and_jax_native(geometry):
    """augment_normalize, normalize and gather: the port's native output
    equals its numpy path's and ``tpudp.native``'s, byte for byte."""
    size, pad, (mean, std) = GEOMETRIES[geometry]
    images = _images(24, size).images
    offsets, flips = loader.draw_augment_params(
        24, np.random.default_rng(1), crop_range=2 * pad + 1)
    got = native.augment_normalize(images, offsets, flips, mean, std,
                                   pad=pad)
    _equal(got, loader.normalize_batch(
        loader.apply_crop_flip(images, offsets, flips, pad=pad), mean, std))
    _equal(got, jax_native.augment_normalize(images, offsets, flips, mean,
                                             std, pad=pad))
    got = native.normalize(images, mean, std)
    _equal(got, loader.normalize_batch(images, mean, std))
    _equal(got, jax_native.normalize(images, mean, std))
    idx = np.random.default_rng(2).integers(0, 24, size=17)
    _equal(native.gather(images, idx), images[idx])
    _equal(native.gather(images, idx), jax_native.gather(images, idx))


def test_numpy_helpers_equal_jax():
    """The loader's numpy functions with pad and statistics equal JAX's."""
    images = _images(8, 64).images
    ours = loader.draw_augment_params(8, np.random.default_rng(3),
                                      crop_range=13)
    theirs = jax_loader.draw_augment_params(8, np.random.default_rng(3),
                                            crop_range=13)
    for a, b in zip(ours, theirs):
        _equal(a, b)
    _equal(loader.apply_crop_flip(images, *ours, pad=6),
           jax_loader.apply_crop_flip(images, *theirs, pad=6))
    _equal(loader.normalize_batch(images, *IMAGENET),
           jax_loader.normalize_batch(images, *IMAGENET))


def test_entry_points_check_their_inputs():
    images = _images(4, 32).images
    offsets, flips = loader.draw_augment_params(4, np.random.default_rng(0))
    with pytest.raises(TypeError, match="uint8"):
        native.normalize(images.astype(np.float32), *CIFAR)
    with pytest.raises(ValueError, match="padded frame"):
        native.augment_normalize(images, offsets + 9, flips, *CIFAR)
    with pytest.raises(ValueError, match="channel statistics"):
        native.normalize(images, np.zeros(2), np.ones(2))
    with pytest.raises(IndexError):
        native.gather(images, np.array([0, 4]))


@pytest.mark.parametrize("geometry", ["32-pad4-cifar", "64-pad8-imagenet"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_native_loader_equals_jax_loaders(geometry, train):
    """Two shards, two epochs, a ragged set (eval pads its last batch):
    the port's native batches equal JAX's numpy and native loaders' and
    the port's numpy loader's, byte for byte."""
    size, pad, (mean, std) = GEOMETRIES[geometry]
    data = _images(45, size)
    kw = dict(train=train, seed=5, mean=mean, std=std, pad=pad)
    for shard in range(2):
        def sampler(cls):
            return cls(45, 2, shard, shuffle=train, seed=5)

        loaders = [
            DataLoader(data, 8, sampler=sampler(ShardedSampler),
                       backend="native", **kw),
            DataLoader(data, 8, sampler=sampler(ShardedSampler),
                       backend="numpy", **kw),
            jax_loader.DataLoader(data, 8, sampler=sampler(JaxSampler),
                                  backend="numpy", **kw),
            jax_loader.DataLoader(data, 8, sampler=sampler(JaxSampler),
                                  backend="native", **kw)]
        assert loaders[0].backend == "native"
        assert len(loaders[0]) == (2 if train else 3)
        for epoch in (0, 1):
            for ld in loaders:
                ld.set_epoch(epoch)
            batches = [list(ld) for ld in loaders]
            assert len({len(b) for b in batches}) == 1
            for got, *wants in zip(*batches):
                for want in wants:
                    for a, b in zip(got, want):
                        _equal(a, b)
            if not train:
                assert batches[0][-1][2].sum() < 8  # padding weighs 0


def test_auto_resolves_to_native():
    assert native.available() and native.load_error() is None
    ld = DataLoader(_images(8, 32), 4)
    assert ld.backend == "native" and ld.native_error is None
    assert ld.banner() == "native"
    assert loader.resolve_backend("numpy") == "numpy"
    with pytest.raises(ValueError, match="unknown backend"):
        DataLoader(_images(8, 32), 4, backend="fast")


def test_failed_build_is_named(tmp_path, monkeypatch):
    """No compiler: ``'native'`` raises with the error, ``'auto'``
    resolves to numpy and keeps it, ``load_error()`` names it; a source
    that does not compile is named with the compiler's message and leaves
    no file behind."""
    monkeypatch.setattr(native, "library", native.Library(
        build_dir=tmp_path / "build", cxx="no-such-compiler++"))
    assert not native.available()
    assert "no-such-compiler++" in native.load_error()
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        DataLoader(_images(8, 32), 4, backend="native")
    ld = DataLoader(_images(8, 32), 4)
    assert ld.backend == "numpy"
    assert "no-such-compiler++" in ld.native_error
    assert ld.banner().startswith("numpy (native unavailable: ")
    assert "\n" not in ld.banner() and "no-such-compiler++" in ld.banner()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.normalize(_images(1, 32).images, *CIFAR)
    broken = tmp_path / "augment.cpp"
    broken.write_text("this is not C++\n")
    lib = native.Library(source=broken, build_dir=tmp_path / "b2")
    assert lib.load() is None
    assert "failed building augment.cpp" in lib.error
    assert "error" in lib.error
    assert list((tmp_path / "b2").iterdir()) == []


def test_edited_source_gets_a_new_library(tmp_path):
    """The library's name hashes the source: a copy builds under the same
    name, an edit under another; builders racing on one name each load
    a whole library."""
    copy = tmp_path / "augment.cpp"
    shutil.copy(native.SOURCE, copy)
    same = native.Library(source=copy, build_dir=tmp_path / "b")
    assert same.path().name == native.library.path().name
    copy.write_text(native.SOURCE.read_text() + "// edited\n")
    edited = native.Library(source=copy, build_dir=tmp_path / "b")
    assert edited.path().name != native.library.path().name
    racers = [native.Library(source=copy, build_dir=tmp_path / "race")
              for _ in range(3)]
    threads = [threading.Thread(target=r.load) for r in racers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert all(r.load() is not None for r in racers), [r.error
                                                       for r in racers]
    assert [p.name for p in (tmp_path / "race").iterdir()] == [
        edited.path().name]
