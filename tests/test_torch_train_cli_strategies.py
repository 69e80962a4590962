"""``tpudp_torch.train_cli``'s parallelism flags (``--mesh``,
``--strategy``, ``--microbatches``, ``--seq-parallel``, ``--num-devices``,
``--master``/``--num-nodes``/``--rank``), against
``examples/train_gpt2.py``'s checks, and its rungs as 4 local gloo ranks
on the CPU: each logs the single-process run's window losses (the same
global batches) — ep, a MoE model of its own, logs finite ones.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from tpudp_torch import train_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--layers", "2", "--d-model", "64", "--heads",
        "2", "--vocab", "128", "--seq-len", "32", "--batch-size", "8",
        "--steps", "4", "--log-every", "2", "--dtype", "float32"]


@pytest.mark.parametrize("argv,match", [
    (["--seq-parallel", "--strategy", "tp"], "its own rung"),
    (["--skip-nonfinite", "2", "--strategy", "tp"], "dp/zero1"),
    (["--num-devices", "4", "--mesh", "2x3"], "needs 6 ranks"),
    (["--mesh", "2"], "DxS"),
    (["--num-devices", "2", "--mesh", "1x2"], "1-D"),
    (["--num-devices", "2", "--mesh", "1x2", "--strategy", "pp",
      "--layers", "3"], "pipeline stages"),
    (["--num-devices", "4", "--mesh", "4x1", "--strategy", "fsdp",
      "--batch-size", "6"], "must split"),
    (["--master", "h"], "needs --master, --num-nodes and --rank"),
    (["--num-devices", "2", "--master", "h", "--num-nodes", "2", "--rank",
      "0"], "spawns local ranks"),
    (["--num-devices", "0"], ">= 1"),
], ids=["sp-with-strategy", "skip-nonfinite", "mesh-size", "mesh-form",
        "dp-2d", "pp-layers", "batch-split", "master-alone",
        "devices-and-master", "devices-0"])
def test_flag_checks(argv, match):
    with pytest.raises(SystemExit, match=match):
        train_cli.parse_args(argv)


def test_microbatches_must_be_positive(capsys):
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--microbatches", "0"])
    assert "--microbatches must be >= 1" in capsys.readouterr().err


def _losses(text: str) -> list[float]:
    return [float(x) for x in re.findall(r"step \d+: loss ([\d.]+)", text)]


@pytest.fixture(scope="module")
def single_process():
    return train_cli.main(TINY)


@pytest.mark.parametrize("flags", [
    ["--mesh", "2x2", "--strategy", "tp"],
    ["--mesh", "2x2", "--strategy", "pp", "--microbatches", "2"],
    ["--mesh", "2x2", "--seq-parallel"],
    ["--mesh", "2x2", "--strategy", "ep"],
], ids=["tp", "pp", "sp", "ep"])
def test_rungs_as_local_ranks(single_process, flags):
    run = subprocess.run(
        [sys.executable, "-m", "tpudp_torch.train_cli", *TINY,
         "--num-devices", "4", *flags], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stderr[-3000:]
    header = run.stdout.splitlines()[0]
    assert "rung=" in header and "mesh" in header, run.stdout
    losses = _losses(run.stdout)
    assert len(losses) == 2, run.stdout  # rank 0 alone prints
    if "ep" in flags:
        assert "params=0.3M" in header and np.isfinite(losses).all()
    else:
        np.testing.assert_allclose(losses, single_process, atol=2e-4)
