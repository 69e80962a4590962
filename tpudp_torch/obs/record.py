"""The span/event recorder — the port of ``tpudp/obs/record.py``, line
for line (it never touched a device there either).

The core is a **preallocated monotonic-clock ring**:

  * :meth:`Recorder.begin` / :meth:`Recorder.end` — the allocation-free
    hot-path API: ``begin`` writes (name, t0) into the next ring record
    and returns an integer token; ``end`` stamps t1 into that record iff
    the ring has not lapped it.  Two ``time.monotonic()`` reads and a few
    attribute stores a span; no container growth, no device touch — the
    engine wraps every device call in one.
  * :meth:`Recorder.event` / :meth:`Recorder.span` — the allocating API
    for everything off the hot path (request admission and retirement,
    recovery decisions, migrations).  Events carry a ``**fields`` dict.
  * :meth:`Recorder.count` — host-side named counters; the device-side
    counters live in the engine's step functions
    (``tpudp_torch/serve/engine.py`` ``OBS_DEVICE_COUNTERS``) and are read
    only by ``metrics()``.

The ring holds the last ``capacity`` records: old telemetry is dropped,
never compacted, which is what the flight recorder
(``tpudp_torch/obs/flight.py``) dumps.  Timestamps are
``time.monotonic()``; each recorder stamps a ``(monotonic, wall)`` anchor
pair at construction so exports can place the timeline in wall time.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time

#: Disabled-recorder token: ``end()`` treats it as a no-op.
NO_SPAN = -1

_RECORDER_IDS = itertools.count()


class _Rec:
    """One preallocated ring slot, reused in place (never reallocated —
    the hot path only stores into existing attributes)."""

    __slots__ = ("seq", "kind", "name", "t0", "t1", "fields")

    def __init__(self):
        self.seq = -1       # ring generation; -1 = never written
        self.kind = ""      # "span" | "event"
        self.name = ""
        self.t0 = 0.0
        self.t1 = -1.0      # -1.0 = span still open
        self.fields = None  # dict for events / tagged spans, else None


class Recorder:
    """Bounded span/event/counter recorder — one per engine/trainer.

    ``enabled=False`` turns every method into an O(1) no-op (the
    overhead-guard test pins the enabled path's cost too).  ``capacity``
    bounds the ring; the newest ``capacity`` records win.
    """

    __slots__ = ("name", "enabled", "capacity", "counters",
                 "anchor_monotonic", "anchor_wall",
                 "_ring", "_seq", "_last_done", "_id")

    def __init__(self, name: str = "", capacity: int = 4096,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = name
        self.enabled = enabled
        self.capacity = capacity
        self.counters: collections.Counter = collections.Counter()
        self.anchor_monotonic = time.monotonic()
        self.anchor_wall = time.time()
        self._ring = [_Rec() for _ in range(capacity)]
        self._seq = 0
        self._last_done = NO_SPAN
        self._id = next(_RECORDER_IDS)

    # -- hot-path API (allocation-free) --------------------------------

    def begin(self, name: str) -> int:
        """Open a span; returns the token :meth:`end` closes.  Safe on
        the scheduler and step hot paths: two attribute stores
        and one clock read, no allocation beyond the returned int."""
        if not self.enabled:
            return NO_SPAN
        seq = self._seq
        rec = self._ring[seq % self.capacity]
        rec.seq = seq
        rec.kind = "span"
        rec.name = name
        rec.fields = None
        rec.t1 = -1.0
        rec.t0 = time.monotonic()
        self._seq = seq + 1
        return seq

    def end(self, token: int) -> None:
        """Close the span ``begin`` opened.  A token the ring has since
        lapped (or :data:`NO_SPAN`) is silently dropped — bounded loss,
        never an error, never a stall."""
        if token < 0 or not self.enabled:
            return
        rec = self._ring[token % self.capacity]
        if rec.seq == token:
            rec.t1 = time.monotonic()
            self._last_done = token

    def count(self, name: str, n: int = 1) -> None:
        """Bump a host-side named counter (Counter add — hot-path safe)."""
        if self.enabled:
            self.counters[name] += n

    # -- off-hot-path API ----------------------------------------------

    def event(self, name: str, **fields) -> None:
        """Record a point event with arbitrary JSON-able fields.  The
        convenient/allocating API: request lifecycle, recovery
        decisions, checkpoint writes — anything off the hot paths."""
        if not self.enabled:
            return
        seq = self._seq
        rec = self._ring[seq % self.capacity]
        rec.seq = seq
        rec.kind = "event"
        rec.name = name
        rec.fields = fields or None
        rec.t0 = time.monotonic()
        rec.t1 = rec.t0
        self._seq = seq + 1
        self._last_done = seq

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        """Context-manager span with tags — the allocating twin of
        ``begin``/``end`` for off-hot-path regions."""
        token = self.begin(name)
        if token >= 0 and fields:
            self._ring[token % self.capacity].fields = fields
        try:
            yield token
        finally:
            self.end(token)

    # -- reads ----------------------------------------------------------

    def __len__(self) -> int:
        return min(self._seq, self.capacity)

    def _record_dict(self, rec: _Rec) -> dict:
        out = {"seq": rec.seq, "kind": rec.kind, "name": rec.name,
               "t0": rec.t0 - self.anchor_monotonic}
        if rec.kind == "span":
            out["dur"] = (rec.t1 - rec.t0) if rec.t1 >= 0.0 else None
        if rec.fields:
            out["fields"] = dict(rec.fields)
        return out

    def snapshot(self) -> list[dict]:
        """The ring's surviving records, oldest first, as plain dicts
        (relative-seconds timestamps).  Tolerates concurrent writers
        (the watchdog's monitor thread snapshots while the scheduler
        records): a record overwritten mid-read is skipped, never a
        crash — the flight recorder prefers a dropped span to a hang."""
        out = []
        top = self._seq
        for seq in range(max(0, top - self.capacity), top):
            rec = self._ring[seq % self.capacity]
            try:
                if rec.seq != seq:
                    continue  # lapped by a concurrent writer
                out.append(self._record_dict(rec))
            except Exception:
                continue
        return out

    def last_span(self) -> dict | None:
        """The most recently COMPLETED record (the watchdog's "last
        thing that finished before the hang")."""
        token = self._last_done
        if token < 0:
            return None
        rec = self._ring[token % self.capacity]
        if rec.seq != token:
            return None
        return self._record_dict(rec)

    def summary(self) -> dict:
        """Per-span-name aggregates over the surviving ring:
        ``{name: {"count": n, "total_s": s}}`` — the cheap rollup
        ``metrics()`` snapshots embed."""
        agg: dict[str, dict] = {}
        for rec in self.snapshot():
            if rec["kind"] != "span" or rec.get("dur") is None:
                continue
            slot = agg.setdefault(rec["name"], {"count": 0, "total_s": 0.0})
            slot["count"] += 1
            slot["total_s"] += rec["dur"]
        for slot in agg.values():
            slot["total_s"] = round(slot["total_s"], 6)
        return agg

    def clear(self) -> None:
        self._seq = 0
        self._last_done = NO_SPAN
        for rec in self._ring:
            rec.seq = -1
        self.counters.clear()
