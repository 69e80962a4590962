"""The Parts' checkpoint flags on the CPU — the counterpart of
``tests/test_cli_eval_only.py``: ``--eval-only`` restores and evaluates
without training (and refuses without ``--checkpoint-dir`` or on an empty
one); an emergency dump resumes mid-epoch with the fast-forward and
refuses a relaunch on another batch grid; ``--checkpoint-async
--keep-checkpoints 1`` leaves one ``step_N``; and, across real process
boundaries, a run whose step hangs under ``--step-timeout`` dumps its
state, exits 42, and its relaunch ends bit-equal to an uninterrupted run
(the final manifests' checksums are equal).  Full-width VGG-11 on 64
synthetic images, driven through ``tpudp_torch.parts.part1``.
"""

import os
import subprocess
import sys

import pytest
import torch

from tpudp_torch.parts import part1
from tpudp_torch.utils import checkpoint as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _argv(root, *extra):
    """64 train images at batch 16: 4 batches an epoch, 1 eval batch."""
    return ["--device", "cpu", "--synthetic-train-size", "64",
            "--synthetic-test-size", "16", "--batch-size", "16",
            "--checkpoint-dir", str(root), *extra]


def _model_leaves(path) -> dict:
    leaves = ck.read_manifest(path)["leaves"]
    return {k: v for k, v in leaves.items()
            if k.startswith((".params", ".batch_stats", ".step",
                             ".loss_sum", ".opt_state"))}


def test_eval_only_restores_and_skips_training(tmp_path, capsys):
    trained = part1.main(_argv(tmp_path / "ck"))
    assert trained.state.step == 4
    want = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("Test set:")]
    evaluated = part1.main(_argv(tmp_path / "ck", "--eval-only"))
    out = capsys.readouterr().out
    assert "resumed from" in out and "Training time" not in out
    assert [x for x in out.splitlines() if x.startswith("Test set:")] == want
    assert evaluated.state.step == trained.state.step
    for a, b in zip(trained.model.state_dict().values(),
                    evaluated.model.state_dict().values()):
        assert (a == b).all()
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_1",
                                                   "step_1.manifest.json"]


def test_eval_only_requires_checkpoint_dir():
    with pytest.raises(SystemExit, match="checkpoint-dir"):
        part1.main(["--device", "cpu", "--eval-only"])


def test_eval_only_empty_checkpoint_dir_errors(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint"):
        part1.main(_argv(tmp_path / "ck", "--eval-only"))


def _dump_at_step(trained, root, step, per_epoch=None):
    trained.state.step = step
    ck.clear_emergency_sentinel(root)
    ck.save_checkpoint(os.path.join(root, "emergency"), trained.state)
    ck.write_emergency_sentinel(root, step=step,
                                per_epoch_batches=per_epoch)


def test_emergency_resume_fast_forwards_cli(tmp_path, capsys):
    """A dump whose step counter sits 2 batches into epoch 1 resumes at
    epoch 1, skipping exactly those 2 of 4, then finishes the epoch."""
    root = tmp_path / "ck"
    trained = part1.main(_argv(root))
    assert trained.state.step == 4
    _dump_at_step(trained, str(root), 6)
    capsys.readouterr()
    resumed = part1.main(_argv(root, "--epochs", "2"))
    out = capsys.readouterr().out
    assert "fast-forwarding 2/4 already-trained batches" in out
    assert "fast-forwarded 2 already-trained batches of epoch 1" in out
    assert resumed.state.step == 8
    assert (root / "emergency.restored").is_dir()


def test_emergency_resume_refuses_changed_batch_grid(tmp_path, capsys):
    root = tmp_path / "ck"
    trained = part1.main(_argv(root))
    _dump_at_step(trained, str(root), 6, per_epoch=4)
    with pytest.raises(SystemExit, match="batches/epoch"):
        part1.main(["--device", "cpu", "--synthetic-train-size", "64",
                    "--synthetic-test-size", "16", "--batch-size", "8",
                    "--checkpoint-dir", str(root), "--epochs", "2"])
    assert (root / "emergency").is_dir()  # refused before consuming it
    capsys.readouterr()
    resumed = part1.main(_argv(root, "--epochs", "2"))
    assert "fast-forwarding 2/4" in capsys.readouterr().out
    assert resumed.state.step == 8


def test_async_checkpoints_keep_one(tmp_path, capsys):
    """--checkpoint-async writes each epoch's state in the background and
    --keep-checkpoints 1 prunes to the newest; it restores bit-equal to a
    synchronous run's."""
    part1.main(_argv(tmp_path / "sync", "--epochs", "2"))
    part1.main(_argv(tmp_path / "async", "--epochs", "2",
                     "--checkpoint-async", "--keep-checkpoints", "1"))
    out = capsys.readouterr().out
    assert "writing in background" in out and "pruned old checkpoint" in out
    assert sorted(os.listdir(tmp_path / "async")) == [
        "step_2", "step_2.manifest.json"]
    assert _model_leaves(tmp_path / "async" / "step_2") == _model_leaves(
        tmp_path / "sync" / "step_2")


HANG = """
import functools, sys, time
from tpudp_torch import cli
from tpudp_torch.training_faults import StallingStep
cli.Trainer = functools.partial(cli.Trainer,
                                step_fault_hook=StallingStep({7}, 120.0))
cli.run_part("none", "t", single_device=True, argv=sys.argv[1:])
"""


def test_hang_dumps_exits_and_resumes_bit_exact(tmp_path):
    """Across process boundaries: the step of device call 7 (epoch 1's
    second batch: 4 train and 1 eval call an epoch) stalls, the watchdog
    dumps the live state and ends the process with 42; the relaunch
    resumes mid-epoch from the dump and its final checkpoint equals an
    uninterrupted run's, checksum for checksum."""
    env = dict(os.environ, OMP_NUM_THREADS="1")  # one thread count for all
    part = [sys.executable, "-m", "tpudp_torch.parts.part1"]
    ref = subprocess.run(part + _argv(tmp_path / "ref", "--epochs", "2"),
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=240)
    assert ref.returncode == 0, ref.stderr[-2000:]
    chaos = str(tmp_path / "chaos")
    args = _argv(chaos, "--epochs", "2")
    hung = subprocess.run([sys.executable, "-c", HANG] + args
                          + ["--step-timeout", "4"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert hung.returncode == 42, hung.stdout[-2000:] + hung.stderr[-2000:]
    assert "FAILURE DETECTED" in hung.stdout
    assert "emergency checkpoint saved" in hung.stdout
    sentinel = ck.read_emergency_sentinel(chaos)
    assert sentinel["step"] == 5 and sentinel["per_epoch_batches"] == 4
    resumed = subprocess.run(part + args, cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=240)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "fast-forwarding 1/4 already-trained batches" in resumed.stdout
    assert _model_leaves(os.path.join(chaos, "step_2")) == _model_leaves(
        tmp_path / "ref" / "step_2")
