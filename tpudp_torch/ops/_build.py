"""Build and load the port's CUDA kernels.

Each ``tpudp_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on first use by ``nvcc`` for ``sm_90a`` into a shared library
under ``tpudp_torch/_build/`` (listed in ``.gitignore``), then loaded
with ``ctypes``.  No PyTorch header is included, so a build takes
seconds, not minutes.  The library name carries a hash of the sources,
so an edited kernel is rebuilt and a stale one is never loaded.

Nothing here runs at import: the CPU tests import every module of the
port on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
#: C signature of each kernel's launch function, in argument order.
SIGNATURES = {
    "paged_decode": ("launch_paged_decode",
                     [_P] * 6 + [_I] * 7 + [_L] * 6 + [_F, _P]),
    "paged_window": ("launch_paged_window",
                     [_P] * 6 + [_I] * 8 + [_L] * 7 + [_F, _P]),
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels are built from source on first "
                       "use")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    lib = _library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish_build(name: str, job) -> None:
    proc, tmp, lib = job
    out, _ = proc.communicate()
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)  # atomic: another process loads a whole file


def build(names=tuple(SIGNATURES)) -> None:
    """Compile every named kernel that is not built yet, one ``nvcc``
    per source, all started together."""
    jobs = {name: _start_build(name) for name in names}
    errors = []
    for name, job in jobs.items():
        if job is None:
            continue
        try:
            _finish_build(name, job)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


def launcher(name: str):
    """The ``ctypes`` launch function of kernel ``name``, building and
    loading its library on first use.  It returns a CUDA error code;
    :func:`check` turns a nonzero one into an exception."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_library_path(name)))
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.tpudp_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpudp_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return getattr(lib, SIGNATURES[name][0])


def check(name: str, code: int) -> None:
    if code:
        msg = _loaded[name].tpudp_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cudaError {code})")
