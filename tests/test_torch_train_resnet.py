"""The port's ResNet trainer (``python -m tpudp_torch.train_resnet``)
against ``examples/train_resnet.py``, on the CPU.

At the JAX package's example-test sizes (``tests/test_examples.py``:
2 steps, global batch 16, 32 images of 32x32, ``--sync ring_uni``) it
prints the example's ``step i: loss ... (... images/s)`` lines with
finite losses and imports nothing of JAX; its synthetic set and loader
statistics are the example's, byte for byte; ``--imagenet-root`` trains
on a local ``.npy`` tree; ``--save-checkpoint`` saves a restorable state.
"""

import os
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpudp_torch import train_resnet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--steps", "2", "--batch-size", "16",
        "--train-size", "32", "--image-size", "32", "--log-every", "1",
        "--sync", "ring_uni"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpudp")


def _run(args, timeout=300):
    """``python -m tpudp_torch.train_resnet args`` in a fresh interpreter,
    then the JAX-side modules it imported."""
    code = ("import runpy, sys\n"
            f"sys.argv = ['train_resnet'] + {args!r}\n"
            "runpy.run_module('tpudp_torch.train_resnet', "
            "run_name='__main__')\n"
            "print('IMPORTED', sorted(m for m in sys.modules if "
            f"m.split('.')[0] in {FORBIDDEN!r}))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _losses(text):
    return [(int(i), float(v)) for i, v in re.findall(
        r"^step (\d+): loss (\S+) \([\d,.]+ images/s\)$", text, re.M)]


def test_prints_the_example_lines():
    text = _run(TINY)
    assert "[resnet50] params=25.6M devices=1 sync=ring_uni image=32 " \
           "batch=16 dtype=bfloat16 device=cpu" in text
    assert "[resnet50] data=native" in text
    losses = _losses(text)
    assert [i for i, _ in losses] == [1, 2]
    assert all(np.isfinite(v) for _, v in losses)
    assert "IMPORTED []" in text


def test_synthetic_set_and_statistics_are_the_examples(monkeypatch):
    """Run the example up to its loader (JAX on the CPU) and take the
    dataset and statistics it hands the loader: the port's are equal."""
    import tpudp.data.loader as jax_loader

    seen = {}

    class Captured(Exception):
        pass

    def capture(dataset, batch_size, **kw):
        seen.update(dataset=dataset, batch=batch_size, **kw)
        raise Captured

    monkeypatch.setattr(jax_loader, "DataLoader", capture)
    monkeypatch.setattr(sys, "argv", ["train_resnet.py", "--batch-size",
                                      "16", "--train-size", "24",
                                      "--image-size", "32", "--num-classes",
                                      "7", "--dtype", "float32"])
    with pytest.raises(Captured):
        runpy.run_path(os.path.join(ROOT, "examples", "train_resnet.py"),
                       run_name="__main__")
    got = train_resnet.synthetic_set(24, 32, 7)
    for a, b in zip(got, seen["dataset"]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got.images.shape == (24, 32, 32, 3)
    np.testing.assert_array_equal(
        np.asarray(train_resnet.IMAGENET_MEAN, np.float32), seen["mean"])
    np.testing.assert_array_equal(
        np.asarray(train_resnet.IMAGENET_STD, np.float32), seen["std"])
    assert seen["seed"] == 0 and seen["train"] is True


def test_imagenet_root_trains_on_a_local_tree(tmp_path):
    """Three classes of .npy files (single images and a stack) load as
    one set, labelled in sorted directory order, and train."""
    rng = np.random.default_rng(4)
    for label, cls in enumerate(("n01", "n02", "n03")):
        d = tmp_path / "train" / cls
        d.mkdir(parents=True)
        np.save(d / "a.npy", rng.integers(0, 256, (32, 32, 3), np.uint8))
        np.save(d / "b.npy", rng.integers(0, 256, (5, 32, 32, 3), np.uint8))
        (d / "notes.txt").write_text("skipped")
    ds = train_resnet.load_npy_tree(str(tmp_path), "train", 32)
    assert ds.images.shape == (18, 32, 32, 3)
    assert ds.labels.tolist() == [0] * 6 + [1] * 6 + [2] * 6
    with pytest.raises(SystemExit, match="expected \\(64, 64, 3\\)"):
        train_resnet.load_npy_tree(str(tmp_path), "train", 64)
    text = _run(TINY + ["--imagenet-root", str(tmp_path), "--num-classes",
                        "3", "--dtype", "float32", "--sync", "allreduce"])
    assert f"loaded 18 images / 3 classes from {tmp_path}" in text
    assert all(np.isfinite(v) for _, v in _losses(text))


def test_save_checkpoint_names_its_roadmap_item(tmp_path):
    """``--save-checkpoint DIR`` (once refused, naming ROADMAP.md slice
    7c) probes DIR before any compute and saves the final state to
    ``DIR/step_<steps>``, which restores into a fresh state bit for bit."""
    from tpudp_torch import train
    from tpudp_torch.models import resnet
    from tpudp_torch.utils import checkpoint as ck

    (tmp_path / "file").write_text("x")
    with pytest.raises(OSError):
        train_resnet.main(TINY + ["--save-checkpoint",
                                  str(tmp_path / "file" / "ck")])
    run = train_resnet.main(TINY + ["--save-checkpoint",
                                    str(tmp_path / "ck")])
    assert run["checkpoint"] == str(tmp_path / "ck" / "step_2")
    fresh = train.init_state(resnet.ResNet(resnet.STAGES[50], 1000),
                             train.make_optimizer(learning_rate=0.1))
    ck.restore_checkpoint(run["checkpoint"], fresh, verify=True)
    assert fresh.step == 2
    for a, b in zip(run["model"].state_dict().values(),
                    fresh.model.state_dict().values()):
        assert torch.equal(a, b.to(a.dtype))


def test_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(SystemExit, match="card.*--device cpu"):
        train_resnet.main(["--steps", "1"])
