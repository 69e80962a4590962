"""A single-client lock per card — the counterpart of
``tpudp/utils/device_lock.py``.

On the TPU a second client wedged the relay; on the card a second
process sharing an H100 with a measured run spoils both measurements.
Every entry point of the port that runs on a card therefore takes this
advisory ``flock`` before its first device touch, so an accidental
second client fails fast with a clear "busy" (exit 2, naming the lock
file) instead of running beside the first.

  * One lock a card, keyed by the card's UUID
    (``torch.cuda.get_device_properties(i).uuid``), so a process that
    sees the card under another index (``CUDA_VISIBLE_DEVICES``) takes
    the same lock; the index where no UUID is available.
  * The lock files live in a directory that every checkout on the
    machine shares: ``TPUDP_CARD_LOCK_DIR``, else ``tpudp_torch_locks``
    under the system temporary directory.  JAX's lock sits inside its
    checkout; here a second checkout is the competitor that matters.
  * Kernel-backed: a crashed or killed holder releases it.
  * Cooperative children: the holder exports the cards it holds in
    ``TPUDP_CARD_LOCKS_HELD`` (JAX exports ``TPUDP_DEVICE_LOCK_HELD=1``),
    so a descendant passes for those cards (the spawned ranks of a
    holder sharing its card, a measurement child) and takes its own
    lock for any other.
  * CPU runs take no lock.
"""

from __future__ import annotations

import atexit
import contextlib
import errno
import fcntl
import os
import re
import sys
import tempfile
import time

import torch

DIR_ENV = "TPUDP_CARD_LOCK_DIR"
HELD_ENV = "TPUDP_CARD_LOCKS_HELD"


def lock_dir() -> str:
    """The machine-wide directory of the cards' lock files."""
    return os.environ.get(DIR_ENV) or os.path.join(tempfile.gettempdir(),
                                                   "tpudp_torch_locks")


def card_key(device=None) -> str:
    """The card's lock name: its UUID, else ``index<N>``.  ``device`` is
    an index, a ``torch.device`` or a string (default: the current
    card)."""
    if isinstance(device, int):
        index = device
    else:
        device = torch.device("cuda" if device is None else device)
        index = device.index
    if torch.cuda.is_available():
        if index is None:
            index = torch.cuda.current_device()
        uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
        if uuid:
            return re.sub(r"[^A-Za-z0-9_.-]", "", str(uuid))
    return f"index{index or 0}"


def lock_path(device=None) -> str:
    return os.path.join(lock_dir(), f"card-{card_key(device)}.lock")


def held_cards() -> set[str]:
    """The cards an ancestor (or this process) holds, by key."""
    return {k for k in os.environ.get(HELD_ENV, "").split(",") if k}


def _export(keys: set[str]) -> None:
    if keys:
        os.environ[HELD_ENV] = ",".join(sorted(keys))
    else:
        os.environ.pop(HELD_ENV, None)


@contextlib.contextmanager
def card_lock(device=None, timeout: float = 0.0, path: str | None = None):
    """Yield False iff a LIVE competing client holds the card's lock after
    ``timeout`` seconds (polled each second; 0: one non-blocking try).

    Every other outcome yields True: held, inherited through
    ``TPUDP_CARD_LOCKS_HELD``, or the locking itself unavailable (a lock
    file that cannot be opened, a filesystem without ``flock``).  Those
    infrastructure failures warn on stderr: the lock protects
    measurements, and a phantom competitor would stop every run.
    """
    key = card_key(device)
    if key in held_cards():
        yield True
        return
    path = path or lock_path(device)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        f = open(path, "w")
    except OSError as e:
        print(f"[device_lock] warning: cannot open lock file {path} ({e}); "
              "proceeding WITHOUT single-client protection",
              file=sys.stderr, flush=True)
        yield True
        return
    acquired = busy = False
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                acquired = True
                break
            except OSError as e:
                if e.errno not in (errno.EAGAIN, errno.EACCES):
                    print(f"[device_lock] warning: flock failed ({e}); "
                          "proceeding WITHOUT single-client protection",
                          file=sys.stderr, flush=True)
                    break
                if time.monotonic() >= deadline:
                    busy = True
                    break
                time.sleep(1.0)
        if acquired:
            _export(held_cards() | {key})  # inherited by children
        try:
            yield not busy
        finally:
            if acquired:
                _export(held_cards() - {key})
                fcntl.flock(f, fcntl.LOCK_UN)
    finally:
        f.close()


_PROCESS_LOCKS: dict = {}  # card key -> its entered card_lock context


def acquire_for_process(device=None, skip: bool = False,
                        timeout: float = 0.0, *, force: bool = False,
                        path: str | None = None) -> None:
    """Hold the card's lock for the rest of the process (released at
    exit).  Call it before the first touch of the card.  A live competing
    client raises ``SystemExit(2)`` with a message naming the lock file.

    Skips itself for a CPU device (unless ``force``, which the tests use
    to exercise the lock without a card) and where ``skip``.  Idempotent:
    a second call for a card this process holds, such as an entry point's
    ``main`` called again in one process, neither takes nor releases it.
    """
    cpu = device is not None and not isinstance(device, int) and \
        torch.device(device).type != "cuda"
    if skip or (cpu and not force):
        return
    if cpu:
        device = 0
    key = card_key(device)
    if key in _PROCESS_LOCKS:
        return
    path = path or lock_path(device)
    ctx = card_lock(device, timeout=timeout, path=path)
    if not ctx.__enter__():
        ctx.__exit__(None, None, None)
        print(f"device_lock: another client holds this card's lock ({path})"
              f" — two processes on one card spoil each other's "
              f"measurements.  Wait for it to finish, or end it.",
              file=sys.stderr, flush=True)
        raise SystemExit(2)
    _PROCESS_LOCKS[key] = ctx
    atexit.register(ctx.__exit__, None, None, None)
