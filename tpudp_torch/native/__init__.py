"""The port's native host data path (C++/OpenMP), loaded through ctypes —
the counterpart of ``tpudp/native/__init__.py``.

``augment.cpp`` (the port's own copy of the JAX package's source, its
symbols prefixed ``tpudp_torch_``) is built at first use with the
system ``g++ -O3 -std=c++17 -shared -fPIC -fopenmp -ffp-contract=off``
into ``tpudp_torch/_build/`` (git-ignored), beside the CUDA kernels.
No ``nvcc`` is needed.  The library's name carries a hash of the source
and the flags, so an edited source builds a new library and a stale one
is never loaded; the build writes a temporary file and ``os.replace``-s
it into place, so ranks that build at once each load a whole file.

A failed build or load is kept, not swallowed: :func:`available` is
False and :func:`load_error` says why.  The loader's ``backend='auto'``
then runs its numpy path, which gives the same bytes (Python draws the
crop and flip decisions for both); ``backend='native'`` raises with the
error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "augment.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
             "-ffp-contract=off")
ABI_VERSION = 1


class Library:
    """The native library built from ``source`` into ``build_dir`` with
    the compiler ``cxx``: built and loaded once, on the first
    :meth:`load`; a failure is recorded in :attr:`error`."""

    def __init__(self, source: Path = SOURCE, build_dir: Path = BUILD_DIR,
                 cxx: str = "g++"):
        self.source = Path(source)
        self.build_dir = Path(build_dir)
        self.cxx = cxx
        self.error: str | None = None
        self._lib: ctypes.CDLL | None = None
        self._attempted = False
        self._lock = threading.Lock()

    def path(self) -> Path:
        """Where the library of this source and these flags lives once
        built."""
        digest = hashlib.sha256(self.source.read_bytes())
        digest.update(" ".join(CXX_FLAGS).encode())
        return self.build_dir / f"libaugment-{digest.hexdigest()[:12]}.so"

    def _build(self, lib: Path) -> None:
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            proc = subprocess.run(
                [self.cxx, *CXX_FLAGS, "-o", str(tmp), str(self.source)],
                capture_output=True, text=True)
        except OSError as exc:  # no compiler
            raise RuntimeError(f"{self.cxx} could not run: {exc}") from None
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{self.cxx} failed building "
                               f"{self.source.name} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader sees a whole file

    def load(self) -> ctypes.CDLL | None:
        """The bound library, building it first if needed; None (with
        :attr:`error` set) when it cannot be built or loaded."""
        with self._lock:
            if self._attempted:
                return self._lib
            self._attempted = True
            try:
                lib = self.path()
                if not lib.exists():
                    self._build(lib)
                self._lib = _bind(ctypes.CDLL(str(lib)))
                version = self._lib.tpudp_torch_native_abi_version()
                if version != ABI_VERSION:
                    self._lib = None
                    raise RuntimeError(f"{lib.name} has ABI version "
                                       f"{version}, not {ABI_VERSION}")
            except (OSError, RuntimeError) as exc:
                self.error = str(exc)
            return self._lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    lib.tpudp_torch_augment_normalize.argtypes = [
        u8p, f32p, i32p, u8p, i64, i64, i64, i64, i64, i64, i64, f32p, f32p]
    lib.tpudp_torch_augment_normalize.restype = None
    lib.tpudp_torch_normalize.argtypes = [u8p, f32p, i64, i64, f32p, f32p]
    lib.tpudp_torch_normalize.restype = None
    lib.tpudp_torch_gather_u8.argtypes = [u8p, i64p, u8p, i64, i64]
    lib.tpudp_torch_gather_u8.restype = None
    lib.tpudp_torch_native_abi_version.argtypes = []
    lib.tpudp_torch_native_abi_version.restype = ctypes.c_int
    return lib


#: The process's library (tests swap in one with another build dir).
library = Library()


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    return library.load()


def available() -> bool:
    return load() is not None


def load_error() -> str | None:
    """Why the library is unavailable (the compiler's or loader's
    message), or None."""
    load()
    return library.error


def _lib() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"the native library is unavailable: "
                           f"{library.error}")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _u8(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype != np.uint8:
        raise TypeError(f"expected uint8 images, got {a.dtype}")
    return a


def _channels(a, c: int) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.float32)
    if a.shape != (c,):
        raise ValueError(f"expected ({c},) channel statistics, got "
                         f"{a.shape}")
    return a


def augment_normalize(images_u8: np.ndarray, offsets: np.ndarray,
                      flips: np.ndarray, mean: np.ndarray, std: np.ndarray,
                      *, pad: int = 4) -> np.ndarray:
    """Fused pad -> crop -> flip -> normalize: uint8 ``(B, H, W, C)`` ->
    float32 ``(B, H, W, C)``, each crop the input's size.  ``offsets``
    are ``(B, 2)`` crop origins in the zero-padded frame and ``flips``
    ``(B,)`` booleans, both drawn by the caller
    (``loader.draw_augment_params``)."""
    lib = _lib()
    images_u8 = _u8(images_u8)
    b, h, w, c = images_u8.shape
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    flips = np.ascontiguousarray(flips, dtype=np.uint8)
    if offsets.shape != (b, 2) or flips.shape != (b,):
        raise ValueError(f"offsets {offsets.shape} and flips {flips.shape} "
                         f"do not fit a batch of {b}")
    if (offsets < 0).any() or (offsets > 2 * pad).any():
        raise ValueError("a crop origin lies outside the padded frame")
    mean, std = _channels(mean, c), _channels(std, c)
    out = np.empty((b, h, w, c), dtype=np.float32)
    lib.tpudp_torch_augment_normalize(
        _ptr(images_u8, ctypes.c_uint8), _ptr(out, ctypes.c_float),
        _ptr(offsets, ctypes.c_int32), _ptr(flips, ctypes.c_uint8),
        b, h, w, h, w, c, pad,
        _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float))
    return out


def normalize(images_u8: np.ndarray, mean: np.ndarray,
              std: np.ndarray) -> np.ndarray:
    """uint8 ``(..., C)`` -> normalized float32, the ToTensor + Normalize
    pair."""
    lib = _lib()
    images_u8 = _u8(images_u8)
    c = images_u8.shape[-1]
    mean, std = _channels(mean, c), _channels(std, c)
    out = np.empty(images_u8.shape, dtype=np.float32)
    lib.tpudp_torch_normalize(_ptr(images_u8, ctypes.c_uint8),
                              _ptr(out, ctypes.c_float), images_u8.size // c,
                              c, _ptr(mean, ctypes.c_float),
                              _ptr(std, ctypes.c_float))
    return out


def gather(data: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``data[idx]`` for a C-contiguous uint8 array of samples, copied on
    every core."""
    lib = _lib()
    data = _u8(data)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= len(data)):
        raise IndexError(f"gather index out of range [0, {len(data)})")
    sample_bytes = int(np.prod(data.shape[1:]))
    out = np.empty((len(idx), *data.shape[1:]), dtype=np.uint8)
    lib.tpudp_torch_gather_u8(_ptr(data, ctypes.c_uint8),
                              _ptr(idx, ctypes.c_int64),
                              _ptr(out, ctypes.c_uint8), len(idx),
                              sample_bytes)
    return out
