"""Fenced step timing — the port of ``tpudp/obs/timing.py``.

CUDA runs asynchronously: a ``time.perf_counter()`` bracket around queued
work measures the queueing, not the work.  :class:`StepTimer` fences on
the measured tensors (:func:`tpudp_torch.utils.profiler.fetch_fence`:
their stream synchronized, one element read) before it reads the clock.
"""

from __future__ import annotations

import time


class StepTimer:
    """Accumulates wall time across steps with fenced edges."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, *block_on) -> float:
        from tpudp_torch.utils.profiler import fetch_fence

        for x in block_on:
            fetch_fence(x)
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.count += 1
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)

    def reset(self) -> None:
        self.total, self.count = 0.0, 0
