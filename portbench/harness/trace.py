"""The profiled sub-window and its reduction.

``torch.profiler`` traces a few steps at the end of a ``--trace 1``
window, inside a ``portbench.profiled`` range that ends after a fence.
The trace is written to a temporary file, read back and reduced to a
summary: the busy and window seconds, device time by kernel name, the
longest idle gaps by the host operation that launched the kernel ending
each gap, the device time of kernels launched inside named host ranges
(the layers that per-layer metrics read).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

import torch

WINDOW = "portbench.profiled"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 160


class Profiled:
    """A profiler over a sub-window: :meth:`start`, the steps, then
    :meth:`stop` with the fence that ends them."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.range = None
        self.window_s = 0.0

    def start(self) -> None:
        self.prof.start()
        self.range = torch.profiler.record_function(WINDOW)
        self.range.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, fence) -> None:
        fence()
        self.window_s = time.perf_counter() - self._t0
        self.range.__exit__(None, None, None)
        self.prof.stop()

    def summary(self, ranges: dict) -> dict:
        """:func:`reduce` of this trace; ``ranges`` maps a label to a
        predicate on host operation names."""
        fd, path = tempfile.mkstemp(prefix="portbench-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        out = reduce(events, ranges)
        out["host_window_s"] = self.window_s
        return out


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _outermost(ops):
    """The ranges of ``ops`` that no other of them contains."""
    out = []
    for e in sorted(ops, key=lambda e: (e["ts"], -e["dur"])):
        if out and e["ts"] + e["dur"] <= out[-1]["ts"] + out[-1]["dur"]:
            continue
        out.append(e)
    return out


class _HostOps:
    """The host operations of each thread, for the innermost one around a
    moment."""

    def __init__(self, ops):
        self.by_tid = {}
        for e in sorted(ops, key=lambda e: e["ts"]):
            self.by_tid.setdefault((e["pid"], e["tid"]), []).append(e)
        self.starts = {k: [e["ts"] for e in v]
                       for k, v in self.by_tid.items()}

    def innermost(self, key, ts: float, limit: int = 4000):
        ops, starts = self.by_tid.get(key, []), self.starts.get(key, [])
        i = bisect.bisect_right(starts, ts) - 1
        for j in range(i, max(i - limit, -1), -1):
            e = ops[j]
            if e["ts"] + e["dur"] >= ts:
                return e
        return None


def reduce(events: list, ranges: dict) -> dict:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if win:
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    else:
        w0, w1 = (min((e["ts"] for e in xs), default=0.0),
                  max((e["ts"] + e["dur"] for e in xs), default=0.0))
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]

    def clipped(e):
        return max(e["ts"], w0), min(e["ts"] + e["dur"], w1)

    busy = _merge(clipped(e) for e in dev)
    by_name: dict = {}
    for e in dev:
        a, b = clipped(e)
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    cpu_ops = [e for e in xs if e.get("cat") == "cpu_op"]
    host = _HostOps(cpu_ops)

    def launch_of(e):
        return launches.get(e.get("args", {}).get("correlation"))

    # device seconds of the kernels launched inside each labelled range
    in_range = {}
    for label, match in ranges.items():
        spans = {}
        for r in _outermost([e for e in cpu_ops if match(e["name"])]):
            spans.setdefault((r["pid"], r["tid"]), []).append(
                (r["ts"], r["ts"] + r["dur"], "Backward" in r["name"]))
        dev_us, calls_fwd, calls_bwd = 0.0, 0, 0
        for v in spans.values():
            calls_bwd += sum(1 for s in v if s[2])
            calls_fwd += sum(1 for s in v if not s[2])
        starts = {k: [s[0] for s in v] for k, v in spans.items()}
        for e in dev:
            ln = launch_of(e)
            if ln is None:
                continue
            key = (ln["pid"], ln["tid"])
            i = bisect.bisect_right(starts.get(key, []), ln["ts"]) - 1
            if i >= 0 and ln["ts"] <= spans[key][i][1]:
                a, b = clipped(e)
                dev_us += b - a
        in_range[label] = {"device_s": dev_us * 1e-6, "fwd_calls": calls_fwd,
                           "bwd_calls": calls_bwd}

    # idle gaps, the longest labelled by the host op behind the next kernel
    first_of = {}
    for e in sorted(dev, key=lambda e: e["ts"]):
        first_of.setdefault(max(e["ts"], w0), e)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    by_host: dict = {}
    for dur, _a, b in gaps[:400]:
        e = first_of.get(b)
        label = "(after the last kernel)"
        if e is not None:
            ln = launch_of(e)
            op = host.innermost((ln["pid"], ln["tid"]), ln["ts"]) \
                if ln is not None else None
            label = op["name"] if op is not None else (
                ln["name"] if ln is not None else "(no launch recorded)")
        by_host[label[:NAME_CHARS]] = by_host.get(label[:NAME_CHARS],
                                                  0.0) + dur

    def top(d):
        return [[k[:NAME_CHARS], v * 1e-6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "device_events": len(dev),
            "ranges": in_range, "device_ops": top(by_name),
            "idle_gaps": top(by_host)}
