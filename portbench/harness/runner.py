"""One run of a cell on one card: its driver's record, and the result
line the metrics' readers make of it."""

from __future__ import annotations

import dataclasses
import sys
import time
import types

from portbench.counts.peaks import peaks
from portbench.harness import common, manifest

#: Top-level modules that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpudp")


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(cell: dict, seed: int, seconds: float, trace: bool, *,
        device_type: str = "cuda", fault: str | None = None,
        t0_wall: float | None = None, tasks: list | None = None,
        **options) -> dict:
    """The driver's record of one run.  ``tasks`` (calibration) runs the
    driver once a task instead, each task a dict of the context's
    ``seed``, ``fault`` and ``precisions``, and gives their records under
    ``tasks``."""
    import torch

    chips = cell["entry"]["chips"]
    if chips != 1:
        raise SystemExit(f"error: the cell asks for {chips} cards; this "
                         "harness runs one-card cells")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card is available")
    device = (torch.device("cuda", 0) if device_type == "cuda"
              else torch.device("cpu"))
    ctx = common.Ctx(config=cell["config"], traffic=cell["traffic"],
                     seed=seed, seconds=seconds, trace=trace, device=device,
                     fault=fault,
                     t0_wall=time.time() if t0_wall is None else t0_wall,
                     **options)
    drv = manifest.driver(cell["traffic"]["driver"])
    if tasks is None:
        return drv.run(ctx)
    return {"tasks": [
        {**task, **drv.run(dataclasses.replace(
            ctx, seed=task["seed"], fault=task.get("fault"),
            precisions=tuple(task.get("precisions", ("fp32",)))))}
        for task in tasks]}


def result(cell: dict, rec: dict, trace: bool) -> dict:
    """The result line of a run's record."""
    import torch

    cuda = torch.cuda.is_available()
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    run = types.SimpleNamespace(
        config=cell["config"], traffic=cell["traffic"], record=rec,
        trace=trace, peaks=peaks(name) if cuda else None)
    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = manifest.reader(m["name"], cell["root"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu", "kind": name,
              "count": 1, "memory_peak_bytes": rec["memory_peak_bytes"]}
    if trace and rec.get("trace"):
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
    attempted = rec["steps"] + rec["profiled_steps"]
    out = {"correct": bool(rec["correct"]), "attempted": attempted,
           "failed": 0 if rec["finite"] else attempted, "metrics": metrics,
           "device": device}
    if trace and rec.get("trace"):
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["compared"] = rec["compared"]
    return out
