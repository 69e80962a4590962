"""Compile caching — the counterpart of ``tpudp/utils/compile_cache.py``.

Both layers answer the question of JAX's module, "have we already paid
for this compile?":

  * :class:`ProgramCache` — an LRU of built programs keyed by ``(cfg,
    id(params))``, with JAX's semantics (a strong reference to
    ``params``, an identity check on every hit, eviction over gets).
    JAX's serve engine freezes the weights into jitted step programs and
    shares them through this cache.  The port's engine has nothing to
    share that way: eager PyTorch compiles nothing per ``Engine``, and a
    captured fused window (``serve/fused.py``) binds one engine's static
    buffers and pool address, so another engine cannot replay it.  No
    build in the port repeats per (config, weights), so the class stands
    here, held to JAX's by the tests, and no engine uses it.  JAX's "churn
    never mints a new trace" reads in the port as "admission and
    retirement never capture a window again": one capture a window
    object (``Engine.metrics()["fused_window"]["captures"]``).
  * :func:`enable_persistent_cache` — the counterpart of JAX's on-disk
    executable cache.  The port's compiles are the ``nvcc`` builds of
    ``tpudp_torch/csrc/*.cu`` (``ops/_build.py``) and the ``g++`` build
    of ``native/augment.cpp``; both build into, and load from,
    :func:`build_dir`.  ``TPUDP_COMPILE_CACHE`` chooses it, as it
    chooses JAX's cache: unset, ``tpudp_torch/_build/`` in the checkout
    (git-ignored); a path, that directory, which may lie outside the
    checkout so that builds outlive it; ``0``, a temporary directory of
    the process, removed at its exit (no cache).  A library's name
    carries a hash of its sources, flags and compiler version, so one
    directory serves any number of checkouts and toolchains, and a
    build writes a temporary file and renames it into place, so
    processes sharing a directory each load a whole library.

:data:`counts` holds this process's compiler runs (``built``) and the
libraries it found already built (``found``), by library file name.
"""

from __future__ import annotations

import atexit
import collections
import functools
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ENV = "TPUDP_COMPILE_CACHE"
#: Where the libraries go when ``TPUDP_COMPILE_CACHE`` is unset.
DEFAULT_DIR = Path(__file__).resolve().parent.parent / "_build"


class ProgramCache:
    """LRU of built programs keyed by ``(cfg, id(params))``.

    ``build(cfg, params)`` runs on a miss; its result is cached and
    returned as-is on later hits.  Entries hold a STRONG reference to
    ``params``, which bounds memory (the LRU evicts whole entries,
    weights included) and makes the ``id()`` key safe: an id can only be
    reused after the object it named was collected, and ours cannot be
    collected while the entry holds it; the ``is`` check then confirms
    the identity on every hit.  ``cfg`` must be hashable.  Eviction is
    LRU over gets, not builds.
    """

    def __init__(self, build, max_entries: int = 8):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self._build = build
        self.max_entries = max_entries
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.builds = 0
        self.hits = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, cfg, params):
        key = (cfg, id(params))
        hit = self._entries.get(key)
        if hit is not None and hit[0] is params:
            self.hits += 1
            self._entries.move_to_end(key)
            return hit[1]
        programs = self._build(cfg, params)
        self.builds += 1
        self._entries[key] = (params, programs)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
        return programs

    def clear(self) -> None:
        self._entries.clear()


#: Libraries by file name, as this process met them: compiled here
#: (``built``) or found already built (``found``, once a lookup).
counts: dict[str, collections.Counter] = {"built": collections.Counter(),
                                          "found": collections.Counter()}

_chosen: tuple[str | None, Path] | None = None  # (the setting, its dir)


def record(outcome: str, library: Path) -> None:
    """Count one ``built`` or ``found`` library (``ops/_build`` and
    ``native`` call it)."""
    counts[outcome][Path(library).name] += 1


@functools.lru_cache(maxsize=None)
def compiler_version(compiler: str) -> str:
    """``<compiler> --version``'s output, which keys the libraries it
    builds; read once a process a compiler.  RuntimeError when it cannot
    run or fails."""
    try:
        proc = subprocess.run([compiler, "--version"], capture_output=True,
                              text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"{compiler} --version could not run: "
                           f"{exc}") from None
    if proc.returncode:
        raise RuntimeError(f"{compiler} --version exited "
                           f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout


def _temporary() -> Path:
    path = Path(tempfile.mkdtemp(prefix="tpudp_torch_build_"))
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    return path


def _resolve(setting: str | None) -> Path:
    """The directory a ``TPUDP_COMPILE_CACHE`` value names, created; an
    unusable one warns and gives the default."""
    if setting == "0":
        return _temporary()
    if not setting:
        return DEFAULT_DIR
    path = Path(setting).expanduser().resolve()
    try:
        path.mkdir(parents=True, exist_ok=True)
        probe = tempfile.NamedTemporaryFile(dir=path, prefix=".probe")
        probe.close()
    except OSError as exc:
        print(f"[compile_cache] warning: cannot build into {path} ({exc}); "
              f"building into {DEFAULT_DIR} instead", file=sys.stderr,
              flush=True)
        return DEFAULT_DIR
    return path


def _choose(setting: str | None) -> Path:
    global _chosen
    if _chosen is None or _chosen[0] != setting:
        _chosen = (setting, _resolve(setting))
    return _chosen[1]


def build_dir() -> Path:
    """The directory the port's libraries are built into and loaded from:
    the one :func:`enable_persistent_cache` chose, else the one
    ``TPUDP_COMPILE_CACHE`` names (so a child process or spawned rank
    follows its parent's setting without a call of its own)."""
    return _chosen[1] if _chosen is not None else _choose(
        os.environ.get(ENV))


def enable_persistent_cache(path: str | None = None, *,
                            force: bool = False) -> str | None:
    """Build into and load from ``path`` (default: what
    ``TPUDP_COMPILE_CACHE`` says, see the module docstring); returns the
    directory in use, or None where nothing is built for the card (no
    CUDA device) unless ``force``.

    Call it before the first build.  Never fatal: a directory that cannot
    be written warns on stderr and the default is used.  A call with the
    setting of the previous one keeps its directory (an entry point's
    ``main`` called again in one process builds nothing twice).
    """
    if not force and not torch.cuda.is_available():
        return None
    return str(_choose(os.environ.get(ENV) if path is None else path))
