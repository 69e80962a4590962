"""CPU rehearsals of whole runs at tiny widths: the result line, the
modules a run loads, the reference's independence, and the planted
faults that the comparison has to catch."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
from conftest import ROOT, tiny_cell

from portbench.harness import runner

SEED = 2 ** 31 + 977  # larger than 32 signed bits hold


def _run(cell, trace=False, fault=None, seed=SEED):
    rec = runner.run(cell, seed, 0.5, trace, device_type="cpu", fault=fault)
    return runner.result(cell, rec, trace)


@pytest.mark.parametrize("name", ["gpt2s-train-t1024", "vgg11-part1-b256"])
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_prints_a_whole_result(name, trace):
    out = _run(tiny_cell(name, float32=True), trace=trace)
    assert out["correct"] is True
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert list(out)[-1] == "compared"
    assert out["failed"] == 0 and out["attempted"] >= 1
    for value, limit in out["compared"].values():
        assert value <= limit
    if not trace:
        assert "setup_s" in out["metrics"]
    else:
        assert "window_s" in out["device"] and "breakdown" in out


def test_same_seed_same_readings():
    a = _run(tiny_cell("gpt2s-train-t1024", float32=True))
    b = _run(tiny_cell("gpt2s-train-t1024", float32=True))
    assert a["compared"] == b["compared"]


_NO_JAX = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    sys.path.insert(0, {tests!r})
    from conftest import tiny_cell
    from portbench.harness import runner
    cell = tiny_cell("gpt2s-train-t1024")
    rec = runner.run(cell, 5, 0.3, True, device_type="cpu")
    runner.result(cell, rec, True)
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")


def test_a_run_loads_no_jax_and_no_jax_package():
    code = _NO_JAX.format(root=ROOT, tests=os.path.join(ROOT, "portbench",
                                                         "tests"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "tpudp_torch" in top  # the program ran
    assert not top & {"jax", "jaxlib", "flax", "tpudp"}


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.gpt2, portbench.reference.vgg\n"
            "import portbench.reference.augment\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for bad in ("tpudp_torch", "tpudp", "jax"):
        assert f"'{bad}'" not in proc.stdout


@pytest.mark.parametrize("name,fault", [
    ("gpt2s-train-t1024", "unchanged"),
    ("gpt2s-train-t1024", "half_batch"),
    ("vgg11-part1-b256", "unchanged"),
    ("vgg11-part1-b256", "half_batch"),
    ("vgg11-part1-b256", "altered_batch"),
])
def test_a_planted_fault_is_not_correct(name, fault):
    out = _run(tiny_cell(name, float32=True), fault=fault)
    assert out["correct"] is False, out["compared"]

