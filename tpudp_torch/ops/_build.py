"""Build and load the port's CUDA kernels.

Each ``tpudp_torch/csrc/<source>.cu`` has a plain C interface and is
compiled on first use by ``nvcc`` for ``sm_90a`` into a shared library
under ``compile_cache.build_dir()`` (by default ``tpudp_torch/_build/``,
listed in ``.gitignore``; ``TPUDP_COMPILE_CACHE`` moves it), then loaded
with ``ctypes``.  A kernel's source is ``<name>.cu`` unless
:data:`SOURCE_OF` names another: the int8 variants of the paged kernels
are further entry points of their fp kernel's source, which instantiates
the one kernel template for both page types.  No PyTorch header is
included, so a build takes seconds, not minutes.  The library name
carries a hash of the source, of every shared header (``csrc/*.cuh``),
of the flags and of ``nvcc --version``, so an edited kernel or another
compiler builds a new library and a stale one is never loaded, in a
build directory that outlives the checkout too.

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

from tpudp_torch.utils import compile_cache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
#: C signature of each kernel's launch function, in argument order.
SIGNATURES = {
    # The decode and window kernels take the key split's scratch and
    # tickets and, after the geometry, their schedule: the row-tile width
    # and split count, and for the window kernels a depth shared by the
    # batch (read where the depth pointer is null).
    "paged_decode": ("launch_paged_decode",
                     [_P] * 8 + [_I] * 9 + [_L] * 6 + [_F, _P]),
    "paged_window": ("launch_paged_window",
                     [_P] * 8 + [_I] * 11 + [_L] * 7 + [_F, _P]),
    "paged_decode_int8": ("launch_paged_decode_int8",
                          [_P] * 10 + [_I] * 9 + [_L] * 10 + [_F, _P]),
    "paged_window_int8": ("launch_paged_window_int8",
                          [_P] * 10 + [_I] * 11 + [_L] * 11 + [_F, _P]),
    "paged_tree": ("launch_paged_tree",
                   [_P] * 9 + [_I] * 8 + [_L] * 10 + [_F, _P]),
    # The flash kernels take their tensors' strides as one host array of
    # (batch, token, head) triples.
    "flash_fwd": ("launch_flash_fwd", [_P] * 6 + [_I] * 6 + [_F, _P]),
    "flash_dq": ("launch_flash_dq", [_P] * 8 + [_I] * 6 + [_F, _P]),
    "flash_dkv": ("launch_flash_dkv", [_P] * 9 + [_I] * 6 + [_F, _P]),
}

#: Kernels whose launch function lives in another kernel's source.
SOURCE_OF = {"paged_decode_int8": "paged_decode",
             "paged_window_int8": "paged_window"}

_loaded: dict[str, ctypes.CDLL] = {}  # by source


class BuildError(RuntimeError):
    """A kernel library could not be built (no ``nvcc``, or ``nvcc``
    failed).  The serving engine does not contain it: it is a fault of
    the program, not of a step."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise BuildError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels are built from source on first "
                       "use")


def source(name: str) -> str:
    """The ``csrc`` source (without ``.cu``) holding kernel ``name``."""
    return SOURCE_OF.get(name, name)


def library_path(src_name: str) -> Path:
    """The shared library built from ``csrc/<src_name>.cu`` (named by the
    hash of its sources, flags and compiler; it exists once built)."""
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{src_name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    try:
        version = compile_cache.compiler_version(_nvcc())
    except RuntimeError as exc:
        raise BuildError(str(exc)) from None
    digest.update(version.encode())
    return (compile_cache.build_dir()
            / f"lib{src_name}-{digest.hexdigest()[:12]}.so")


def _start_build(src_name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    lib = library_path(src_name)
    if lib.exists():
        compile_cache.record("found", lib)
        return None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{src_name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish_build(src_name: str, job) -> None:
    proc, tmp, lib = job
    out, _ = proc.communicate()
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed building {src_name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)  # atomic: another process loads a whole file
    compile_cache.record("built", lib)


def build(names=tuple(SIGNATURES)) -> None:
    """Compile the sources of every named kernel that are not built yet,
    one ``nvcc`` per source, all started together."""
    sources = dict.fromkeys(map(source, names))  # ordered, deduplicated
    jobs = {src: _start_build(src) for src in sources}
    errors = []
    for src, job in jobs.items():
        if job is None:
            continue
        try:
            _finish_build(src, job)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise BuildError("\n".join(errors))


def launcher(name: str):
    """The ``ctypes`` launch function of kernel ``name``, building and
    loading its library on first use.  It returns a CUDA error code;
    :func:`check` turns a nonzero one into an exception."""
    src = source(name)
    lib = _loaded.get(src)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(src)))
        for kernel, (symbol, argtypes) in SIGNATURES.items():
            if source(kernel) == src:
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.tpudp_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpudp_cuda_error_string.restype = ctypes.c_char_p
        _loaded[src] = lib
    return getattr(lib, SIGNATURES[name][0])


def check(name: str, code: int) -> None:
    if code:
        msg = _loaded[source(name)].tpudp_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cudaError {code})")
