"""Exporters — the port of ``tpudp/obs/export.py``: Chrome/Perfetto
``trace_event`` JSON and plain snapshots of a recorder ring.

  * :func:`to_chrome_trace` — the ``traceEvents`` array Perfetto
    (https://ui.perfetto.dev) and ``chrome://tracing`` load: spans become
    complete ("X") events in microseconds, point events instant ("i")
    events, counters one counter ("C") sample; ``pid`` is the host index,
    ``tid`` the component name.
  * :func:`spans_from_chrome_trace` / :func:`counters_from_chrome_trace`
    — the inverse mapping, the identity on (name, kind, t0, dur, fields).
  * :func:`snapshot_json` — the ring and counters as one JSON document
    (the flight recorder's payload shape).
"""

from __future__ import annotations

import json

from tpudp_torch.obs.record import Recorder

_US = 1e6


def to_chrome_trace(recorder: Recorder, *, pid: int = 0,
                    tid: str | None = None) -> dict:
    """Recorder ring → Chrome ``trace_event`` JSON object."""
    tid = tid if tid is not None else (recorder.name or "tpudp")
    events = []
    for rec in recorder.snapshot():
        ts = rec["t0"] * _US
        base = {"name": rec["name"], "pid": pid, "tid": tid,
                "cat": "tpudp"}
        if rec.get("fields"):
            base["args"] = rec["fields"]
        if rec["kind"] == "span":
            dur = rec.get("dur")
            events.append({**base, "ph": "X", "ts": ts,
                           "dur": (dur if dur is not None else 0.0) * _US,
                           **({"args": {**base.get("args", {}),
                                        "open": True}}
                              if dur is None else {})})
        else:
            events.append({**base, "ph": "i", "ts": ts, "s": "t"})
    for name, value in sorted(recorder.counters.items()):
        events.append({"name": name, "ph": "C", "pid": pid, "tid": tid,
                       "cat": "tpudp", "ts": 0.0,
                       "args": {"value": value}})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "component": recorder.name,
            "anchor_wall": recorder.anchor_wall,
        },
    }


def spans_from_chrome_trace(trace: dict) -> list[dict]:
    """Chrome trace object → recorder-snapshot-shaped dicts (the
    round-trip inverse; counter samples are skipped — they come back
    through the counters dict, not the ring)."""
    out = []
    for ev in trace.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "X":
            args = dict(ev.get("args") or {})
            open_span = bool(args.pop("open", False))
            rec = {"kind": "span", "name": ev["name"],
                   "t0": ev["ts"] / _US,
                   "dur": None if open_span else ev.get("dur", 0.0) / _US}
            if args:
                rec["fields"] = args
            out.append(rec)
        elif ph == "i":
            rec = {"kind": "event", "name": ev["name"],
                   "t0": ev["ts"] / _US}
            if ev.get("args"):
                rec["fields"] = dict(ev["args"])
            out.append(rec)
    return out


def counters_from_chrome_trace(trace: dict) -> dict:
    """Counter ("C") samples of a :func:`to_chrome_trace` export."""
    out = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "C":
            out[ev["name"]] = ev.get("args", {}).get("value")
    return out


def snapshot_json(recorder: Recorder, **extra) -> str:
    """The ring + counters as one pretty-printed JSON document."""
    return json.dumps(
        {"component": recorder.name, "anchor_wall": recorder.anchor_wall,
         "counters": dict(recorder.counters),
         "spans": recorder.snapshot(), **extra},
        indent=1, sort_keys=True, default=str)
