"""Deterministic fault injection for the training stack — the port of
``tpudp/training_faults.py``: the supervisor's test fixtures.

Which batch is poisoned, which step raises and which checkpoint byte
flips are fixed by constructor arguments, so a failing run replays
exactly:

  * :class:`CorruptingLoader` poisons batch DRAWS by a global draw
    counter that only moves forward: ``nan_at`` yields NaN images (NaN
    loss, the divergence case), ``spike_at`` scales them by
    ``spike_scale`` (a finite loss spike).  A rollback's replay draws
    under new indices, so each fault fires once.
  * :class:`RaisingStep` and :class:`StallingStep` are
    ``Trainer(step_fault_hook=...)`` callables, called as
    ``hook(kind, index)`` right before each device step (``kind`` is
    ``"train"`` or ``"eval"``; a retried step gets a new ``index``).
  * :class:`RaisingLoader` raises from the data pipeline at a draw, as a
    dying loader or Prefetcher worker would.

Plus :func:`corrupt_checkpoint`: a byte flip, a truncation or a tampered
manifest.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class InjectedTrainingFault(RuntimeError):
    """Raised by the injectors below, so a test can tell an injected
    failure from an organic one."""


class _LoaderWrapper:
    """Forwards the loader protocol (``set_epoch``, ``__len__``,
    ``set_place``) so a wrapped loader still composes with the Trainer
    and the Prefetcher."""

    def __init__(self, loader):
        self.loader = loader

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def set_place(self, fn) -> None:
        if hasattr(self.loader, "set_place"):
            self.loader.set_place(fn)

    def __len__(self) -> int:
        return len(self.loader)


def _scaled(images, factor: float):
    """``images * factor`` for a numpy array or a tensor, in its dtype."""
    if isinstance(images, np.ndarray):
        return images * np.asarray(factor, images.dtype)
    return images * factor


class CorruptingLoader(_LoaderWrapper):
    """Poisons the GLOBAL draw indices (0-based, counted across epochs and
    pipeline restarts) in ``nan_at`` and ``spike_at``; ``fired`` records
    ``(kind, draw_index)``."""

    def __init__(self, loader, *, nan_at=(), spike_at=(),
                 spike_scale: float = 1e4):
        super().__init__(loader)
        self.nan_at = set(nan_at)
        self.spike_at = set(spike_at)
        self.spike_scale = spike_scale
        self.draws = 0
        self.fired: list[tuple[str, int]] = []

    def __iter__(self):
        for images, labels, weights in self.loader:
            i = self.draws
            self.draws += 1
            if i in self.nan_at:
                self.fired.append(("nan", i))
                images = _scaled(images, float("nan"))
            elif i in self.spike_at:
                self.fired.append(("spike", i))
                images = _scaled(images, self.spike_scale)
            yield images, labels, weights


class RaisingLoader(_LoaderWrapper):
    """Raises :class:`InjectedTrainingFault` instead of yielding the draws
    in ``fail_at`` (global draw indices; the failed draw is counted, so
    the restarted pipeline passes it under a new index)."""

    def __init__(self, loader, fail_at=()):
        super().__init__(loader)
        self.fail_at = set(fail_at)
        self.draws = 0
        self.fired: list[tuple[str, int]] = []

    def __iter__(self):
        for batch in self.loader:
            i = self.draws
            self.draws += 1
            if i in self.fail_at:
                self.fired.append(("loader", i))
                raise InjectedTrainingFault(
                    f"injected loader failure at draw {i}")
            yield batch


class RaisingStep:
    """Step hook that raises :class:`InjectedTrainingFault` when the
    trainer's device-call ``index`` is in ``fail_at`` (optionally only for
    one ``kind``); ``persist_from`` fails every call from that index on,
    the permanent fault that the same-step budget exists for."""

    def __init__(self, fail_at=(), kind: str | None = None,
                 persist_from: int | None = None):
        self.fail_at = set(fail_at)
        self.kind = kind
        self.persist_from = persist_from
        self.fired: list[tuple[str, int]] = []

    def __call__(self, kind: str, index: int) -> None:
        hit = index in self.fail_at or (
            self.persist_from is not None and index >= self.persist_from)
        if hit and (self.kind is None or kind == self.kind):
            self.fired.append((kind, index))
            raise InjectedTrainingFault(
                f"injected step fault at {kind} call {index}")


class StallingStep:
    """Step hook that sleeps ``delay_s`` before the configured device
    calls — a wedged step for the watchdog to catch."""

    def __init__(self, stall_at, delay_s: float, kind: str | None = None):
        self.stall_at = set(stall_at)
        self.delay_s = delay_s
        self.kind = kind
        self.fired: list[tuple[str, int]] = []

    def __call__(self, kind: str, index: int) -> None:
        if index in self.stall_at and (self.kind is None
                                       or kind == self.kind):
            self.fired.append((kind, index))
            time.sleep(self.delay_s)


def corrupt_checkpoint(path: str | os.PathLike, mode: str = "flip") -> str:
    """Corrupt the checkpoint at ``path`` deterministically and return the
    file touched: ``"flip"`` XORs the middle byte of the largest tensor
    record of its largest file (silent rot: the load succeeds, the
    manifest catches it),
    ``"truncate"`` cuts that file in half (a torn write), ``"manifest"``
    tampers a checksum in the manifest beside the directory."""
    from tpudp_torch.utils.checkpoint import manifest_path

    path = os.path.abspath(os.fspath(path))
    if mode == "manifest":
        mpath = manifest_path(path)
        with open(mpath) as f:
            manifest = json.load(f)
        leaves = manifest.get("leaves", {})
        for key in sorted(leaves):
            if "crc32" in leaves[key]:
                leaves[key]["crc32"] ^= 0x1
                break
        else:
            raise ValueError(f"no checksummed leaf in {mpath}")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        return mpath
    if mode not in ("flip", "truncate"):
        raise ValueError(f"unknown corruption mode {mode!r}")
    files = []
    for dirpath, _dirs, names in os.walk(path):
        for name in names:
            p = os.path.join(dirpath, name)
            files.append((os.path.getsize(p), p))
    if not files:
        raise ValueError(f"no files under checkpoint dir {path}")
    _, target = max(files)
    size = os.path.getsize(target)
    if mode == "truncate":
        with open(target, "r+b") as f:
            f.truncate(max(size // 2, 1))
        return target
    at = _largest_record_middle(target)
    with open(target, "r+b") as f:
        f.seek(size // 2 if at is None else at)
        b = f.read(1)
        f.seek(size // 2 if at is None else at)
        f.write(bytes([b[0] ^ 0xFF]))
    return target


def _largest_record_middle(path: str) -> int | None:
    """The file offset of the middle byte of the largest tensor record in
    a ``torch.save`` archive (a zip whose records are padded, so the
    file's own middle byte may be padding), or None for another file."""
    import struct
    import zipfile

    if not zipfile.is_zipfile(path):
        return None
    with zipfile.ZipFile(path) as z:
        info = max(z.infolist(), key=lambda i: i.file_size)
    if info.file_size == 0:
        return None
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        header = f.read(30)
    name_len, extra_len = struct.unpack("<HH", header[26:30])
    return (info.header_offset + 30 + name_len + extra_len
            + info.file_size // 2)
