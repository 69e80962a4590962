"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``configs/<config>.json`` (the manifest's
``file``), its traffic ``workloads/<traffic>.json``, whose ``driver``
names a module of ``portbench/drivers``, and each metric a reader
``metrics/<name>.py`` with ``read(run) -> float | None``.  Adding a
cell or a metric is adding files and manifest entries.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: str = ROOT, manifest: dict | None = None) -> dict:
    """The cell called ``name``, resolved: its manifest entry, its
    configuration, its traffic, and its end-to-end and per-layer
    metrics."""
    m = manifest or load(root)
    by_name = {w["name"]: w for w in m["workloads"]}
    if name not in by_name:
        raise SystemExit(f"error: no workload {name!r} in BENCHMARK.json "
                         f"(have {', '.join(sorted(by_name))})")
    w = by_name[name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    e2e = [x for x in m["end_to_end"]
           if "workloads" not in x or name in x["workloads"]]
    reported = {x["name"] for x in e2e}
    layers = [x for x in m["per_layer"]
              if (name in x["workloads"] if "workloads" in x
                  else x["moves"] in reported)]
    return {"entry": w,
            "config": _read_json(os.path.join(root, conf["file"])),
            "traffic": _read_json(os.path.join(
                root, "portbench", "workloads", w["traffic"] + ".json")),
            "end_to_end": e2e, "per_layer": layers, "root": root}


def reader(name: str, root: str = ROOT):
    """The ``read`` function of metric ``name``'s reader file."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(name: str):
    """The driver module a traffic file names."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad driver name {name!r}")
    return importlib.import_module(f"portbench.drivers.{name}")
