"""BENCHMARK.json against the benchmark's contract, and the files it
names found by name (a new cell and a new metric are files)."""

import json
import os
import re
import shutil

import pytest
from conftest import ROOT

from portbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT_KEYS = ("why", "layer", "source")


@pytest.fixture(scope="module")
def m():
    return manifest.load(ROOT)


def test_top_level_keys(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"]
    assert m["command"][1] == "portbench/run.py"
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024


def test_names_units_and_text(m):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in TEXT_KEYS:
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                        and "\t" not in e[k], (e["name"], k)
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len(names) == len(set(names))


def test_entries_have_the_contract_keys(m):
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(
        1, len(m["workloads"]) // 4)


def test_every_cell_resolves_and_reports_enough(m):
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for w in m["workloads"]:
        cell = manifest.cell(w["name"], root=ROOT)
        assert cell["config"]["name"] == w["config"]
        manifest.driver(cell["traffic"]["driver"])
        reported = {e["name"] for e in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]
        for e in cell["per_layer"]:
            assert e["moves"] in reported
        for e in cell["end_to_end"] + cell["per_layer"]:
            assert callable(manifest.reader(e["name"], ROOT))
        assert set(cell["traffic"]["limits"]) >= {"loss", "grad", "change"}


def test_config_files_match_the_manifest(m):
    files = [c["file"] for c in m["configs"]]
    assert len(files) == len(set(files))
    for c in m["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert "assumed" in conf


def test_a_new_cell_and_metric_are_picked_up_from_files(tmp_path, m):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads(json.dumps(m))
    with open(root / "portbench/workloads/lm-b8-t1024.json", "w") as f:
        json.dump({**manifest.cell("gpt2s-train-t1024", ROOT)["traffic"],
                   "batch": 8}, f)
    (root / "portbench/metrics/steps_seen.lm.py").write_text(
        "def read(run):\n    return float(run.main['steps'])\n")
    new["workloads"].append({"name": "gpt2s-train-b8", "config": "gpt2-small",
                             "traffic": "lm-b8-t1024", "chips": 1,
                             "why": "a smaller batch"})
    new["end_to_end"][0]["workloads"].append("gpt2s-train-b8")
    new["per_layer"].append({"name": "steps_seen.lm", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "train step",
                             "moves": "lm_tokens_per_s",
                             "workloads": ["gpt2s-train-b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = manifest.cell("gpt2s-train-b8", root=str(root))
    assert cell["traffic"]["batch"] == 8
    assert [e["name"] for e in cell["per_layer"]] == ["steps_seen.lm"]
    read = manifest.reader("steps_seen.lm", str(root))
    assert read(type("Run", (), {"main": {"steps": 7}})) == 7.0
