"""Background-thread batch prefetching — the port's copy of
``tpudp/data/prefetch.py``, with a device placement hook for PyTorch.

One daemon thread runs the wrapped loader (numpy code that releases the
GIL) ``depth`` batches ahead of the consumer.  Its ``place`` hook runs on
that thread too: :func:`device_place` copies each batch into pinned host
memory and on to the card with ``non_blocking=True``, so the host-to-
device copies are queued before the step that reads them.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


def device_place(device: torch.device):
    """The placement hook for ``device``: each array of a batch becomes a
    tensor there — through pinned memory and a non-blocking copy on a
    CUDA device, as a zero-copy view of the numpy array on the CPU."""
    device = torch.device(device)

    def place(batch):
        out = []
        for a in batch:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out.append(t)
        return tuple(out)

    return place


class Prefetcher:
    """Wraps a loader (an iterable of batches with ``set_epoch`` and
    ``__len__``) and prepares up to ``depth`` batches ahead on a daemon
    thread; order and content are the loader's.  ``place`` (or
    :meth:`set_place`) runs on that thread for each batch."""

    _DONE = object()

    def __init__(self, loader, depth: int = 2, place=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.loader = loader
        self.depth = depth
        self.place = place
        self._lock = threading.Lock()
        self._live: list[tuple[threading.Event, threading.Thread]] = []

    def close(self, timeout: float = 5.0) -> None:
        """Stop every live worker thread and wait for it; idempotent, and
        the Prefetcher stays iterable (a new ``__iter__`` starts a new
        worker)."""
        with self._lock:
            live = list(self._live)
        for stop, _t in live:
            stop.set()
        for _stop, t in live:
            t.join(timeout)
        with self._lock:
            self._live = [e for e in self._live if e[1].is_alive()]

    def set_place(self, fn) -> None:
        """Install or replace the placement hook (for batches queued
        after this call)."""
        self.place = fn

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker() -> None:
            try:
                for batch in self.loader:
                    if self.place is not None:
                        batch = self.place(batch)
                    if not put(batch):
                        return
                put(self._DONE)
            except BaseException as e:  # re-raised on the consumer side
                put(e)

        t = threading.Thread(target=worker, daemon=True,
                             name="tpudp-prefetch")
        with self._lock:
            self._live.append((stop, t))
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            with self._lock:
                self._live = [e for e in self._live if e[0] is not stop]
