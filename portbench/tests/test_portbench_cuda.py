"""On the card, at each cell's own size: the control (the plain
reference at the precision below the configuration's, put in the
program's place) is not correct by the cell's limits, where the program
on the same seeds is.  Run on the card with

    python -m pytest -p no:cacheprovider portbench/tests/test_portbench_cuda.py
"""

import pytest
from conftest import ROOT

from portbench.harness import compare, manifest, runner

SEEDS = (3_000_000_011, 3_000_000_012, 3_000_000_013)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gpt2s-train-t1024", "vgg11-part1-b256"])
def test_the_control_fails_where_the_program_passes(card, name):
    cell = manifest.cell(name, root=ROOT)
    control = cell["config"]["control"]
    limits = cell["traffic"]["limits"]
    tasks = [{"seed": s, "precisions": ["fp32", control]} for s in SEEDS]
    rec = runner.run(cell, 0, 0.0, False, check_only=True, tasks=tasks)
    for task in rec["tasks"]:
        assert compare.judge(task["numbers"], limits)[0], task["numbers"]
        assert not compare.judge(task[f"control_{control}"], limits)[0], \
            task[f"control_{control}"]
