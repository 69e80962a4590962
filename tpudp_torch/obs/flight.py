"""Fault-triggered flight recorder — the port of ``tpudp/obs/flight.py``:
the last N spans, events and counters, persisted the moment something
goes wrong.

A :class:`FlightRecorder` wraps a :class:`Recorder` and, on demand, dumps
its ring plus context to ``flightrec-<component>-h<host>-<seq>-<reason>.json``
under a configured directory: JAX's file names and payload keys.  It is
dumped on watchdog timeouts, serving step-failure containment, canary
quarantine, quarantined migration transfers and training rollbacks.

Activation is by directory: ``directory=None`` resolves through the
``TPUDP_FLIGHT_DIR`` environment variable, and when neither is set every
``dump()`` is a no-op.

Several ranks: each dumps locally (a dump must never need a dead peer),
and :func:`coordinated_merge` — called only where every live rank
arrives together — has rank 0 merge the per-rank files into one
``flightrec-merged.json`` after a ``gather_host_values`` round over
``torch.distributed``.  The host index is the process's rank in the
default group (0 without one).
"""

from __future__ import annotations

import json
import os
import time

from tpudp_torch.obs.record import Recorder

#: Environment default for the dump directory (CLI flags/constructor
#: arguments override).  Unset + no explicit directory = dumps disabled.
FLIGHT_DIR_ENV = "TPUDP_FLIGHT_DIR"


def resolve_flight_dir(directory: str | None) -> str | None:
    """Explicit directory, else the ``TPUDP_FLIGHT_DIR`` env default,
    else None (dumping disabled)."""
    if directory:
        return directory
    return os.environ.get(FLIGHT_DIR_ENV) or None


def _host_index() -> int:
    """This process's rank in the default process group (0 without one).
    Read, never initialized: the dump path may run while a peer is
    dead."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


class FlightRecorder:
    """Dumps a :class:`Recorder`'s ring to per-host JSON files.

    One instance per engine/trainer; ``dump()`` is safe from any thread
    (the watchdog's monitor thread calls it right before killing the
    process) and never raises — a broken disk must not mask the fault
    being recorded.
    """

    def __init__(self, recorder: Recorder, directory: str | None = None,
                 component: str = ""):
        self.recorder = recorder
        self.directory = resolve_flight_dir(directory)
        self.component = component or recorder.name or "tpudp"
        self._dumped = 0

    @property
    def enabled(self) -> bool:
        return self.directory is not None

    @property
    def dumps(self) -> int:
        """Dumps successfully written by THIS instance."""
        return self._dumped

    def dump(self, reason: str, extra: dict | None = None) -> str | None:
        """Persist the black box: ring snapshot + counters + context.
        Returns the written path, or None when disabled or the write
        failed (best-effort by contract)."""
        if self.directory is None:
            return None
        try:
            host = _host_index()
            rec = self.recorder
            payload = {
                "kind": "tpudp_flight_record",
                "component": self.component,
                "reason": reason,
                "host": host,
                "seq": self._dumped,
                "wall_time": time.time(),
                "anchor_wall": rec.anchor_wall,
                "counters": dict(rec.counters),
                "last_span": rec.last_span(),
                "spans": rec.snapshot(),
            }
            if extra:
                payload["extra"] = extra
            os.makedirs(self.directory, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in reason)[:48]
            path = os.path.join(
                self.directory,
                f"flightrec-{self.component}-h{host}-"
                f"{self._dumped:03d}-{safe}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1, sort_keys=True,
                          default=str)
                f.write("\n")
            os.replace(tmp, path)
            self._dumped += 1
            return path
        except Exception:
            return None  # best-effort: never mask the fault being recorded


def list_dumps(directory: str) -> list[str]:
    """Sorted flight-record files under ``directory`` (sorted so every
    host walks the same order — the merge below is a coordination-
    adjacent path)."""
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return []
    return [os.path.join(directory, n) for n in names
            if n.startswith("flightrec-") and n.endswith(".json")
            and "merged" not in n]


def merge_dumps(directory: str) -> str | None:
    """Merge every per-host flight record under ``directory`` into
    ``flightrec-merged.json`` (records sorted by host then sequence).
    Pure file I/O — callable post-mortem on a dead pod's shared dir."""
    paths = list_dumps(directory)
    if not paths:
        return None
    records = []
    for p in paths:
        try:
            with open(p, encoding="utf-8") as f:
                records.append(json.load(f))
        except (OSError, json.JSONDecodeError):
            records.append({"kind": "tpudp_flight_record",
                            "error": f"unreadable dump {p}"})
    records.sort(key=lambda r: (r.get("host", 0), r.get("seq", 0)))
    out = os.path.join(directory, "flightrec-merged.json")
    tmp = out + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"kind": "tpudp_flight_record_merged",
                   "merged": len(records), "records": records}, f,
                  indent=1, sort_keys=True, default=str)
        f.write("\n")
    os.replace(tmp, out)
    return out


def coordinated_merge(directory: str | None) -> str | None:
    """Rank 0 merges the per-rank dumps, after a ``gather_host_values``
    round confirms every live rank's dump count (every rank must call
    this together, from a point all of them reach — never from a path
    where a peer may be dead).  One process: the plain local merge.
    Returns rank 0's merged path (None elsewhere, or when disabled)."""
    directory = resolve_flight_dir(directory)
    if directory is None:
        return None
    from tpudp_torch.utils.checkpoint import gather_host_values, world_size

    if world_size() > 1:
        gather_host_values(len(list_dumps(directory)))
    if _host_index() == 0:
        return merge_dumps(directory)
    return None
