"""The port's Part entry points (``python -m tpudp_torch.parts.part*``)
and its epoch ``Trainer``, on the CPU.

Each Part runs full-width VGG-11 at a tiny data size (320 synthetic
train images, global batch 8: 40 iterations, two log windows) with
``--device cpu`` — Parts 2a, 2b and 3 on 2 or 4 gloo ranks — and must
print the reference's lines, importing nothing of JAX or the JAX
package, and its banner must name the loader's resolved backend.
Part 1 runs on the native backend, Part 2b with ``--sync-bn``, Part 3
with ``--spmd-mode gspmd``.  Without ``--device cpu`` and without a card
a Part fails naming the card; the flags once refused for later slices
(``--verify-replicas``, the obs flags) run.
The Trainer's window and eval numbers are held to the JAX Trainer's on
the same weights and batches.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.data import DataLoader as JaxLoader
from tpudp.data import ShardedSampler as JaxSampler
from tpudp.models.vgg import VGG as JaxVGG
from tpudp.train import Trainer as JaxTrainer
from tpudp_torch.data import DataLoader, ShardedSampler, load_cifar10
from tpudp_torch.mesh import Mesh
from tpudp_torch.models import vgg
from tpudp_torch.parts import part1, part2b, part3
from tpudp_torch.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--synthetic-train-size", "320",
        "--synthetic-test-size", "40", "--batch-size", "8"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpudp")


def _run_part(module, args, timeout=240):
    """Run ``python -m module args`` in a fresh interpreter through runpy,
    then list the JAX-side modules it imported."""
    code = ("import runpy, sys\n"
            f"sys.argv = [{module!r}] + {args!r}\n"
            f"runpy.run_module({module!r}, run_name='__main__')\n"
            "print('IMPORTED', sorted(m for m in sys.modules if "
            f"m.split('.')[0] in {FORBIDDEN!r}))\n")
    # One thread a rank: the suite's workers share the host's cores.
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


PART_RUNS = {
    "part1": ("tpudp_torch.parts.part1", [], "none", 1),
    "part1-native": ("tpudp_torch.parts.part1", ["--data-backend", "native"],
                     "none", 1),
    "part2a-w2": ("tpudp_torch.parts.part2a",
                  ["--num-devices", "2", "--data-backend", "numpy"],
                  "coordinator", 2),
    "part2b-w4": ("tpudp_torch.parts.part2b", ["--num-devices", "4"],
                  "allreduce", 4),
    "part2b-ring-w2": ("tpudp_torch.parts.part2b",
                       ["--ring", "--num-devices", "2"], "ring", 2),
    "part2b-int8-w2": ("tpudp_torch.parts.part2b",
                       ["--int8-grads", "--num-devices", "2"],
                       "allreduce_int8", 2),
    "part2b-sync-bn-w2": ("tpudp_torch.parts.part2b",
                          ["--sync-bn", "--num-devices", "2"], "allreduce",
                          2),
    "part3-w2": ("tpudp_torch.parts.part3", ["--num-devices", "2"], "auto",
                 2),
    "part3-gspmd-w2": ("tpudp_torch.parts.part3",
                       ["--spmd-mode", "gspmd", "--num-devices", "2"],
                       "auto", 2),
}


@pytest.mark.parametrize("case", sorted(PART_RUNS))
def test_part_prints_the_reference_lines(case):
    module, extra, sync, world = PART_RUNS[case]
    out = _run_part(module, TINY + extra)
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    assert f"sync={sync} devices={world} device=cpu" in text
    # 'auto' resolves to the native backend here (g++ builds it).
    backend = "numpy" if "numpy" in extra else "native"
    assert f"data={backend}+prefetch2" in text
    losses = re.findall(r"^Training loss after (\d+) iterations is (\S+)$",
                        text, re.M)
    # 320 images at a global batch of 8: 40 iterations on every rank.
    assert [int(n) for n, _ in losses] == [20, 40]
    assert all(np.isfinite(float(v)) for _, v in losses)
    assert re.search(r"^Average Pass time in iter 40 is \S+$", text, re.M)
    assert re.search(r"^Training time after 1 epoch is \S+$", text, re.M)
    assert re.search(r"^Test set: Average loss: [\d.]+, Accuracy: \d+/40 "
                     r"\(\d+%\)$", text, re.M)
    assert text.count("Test set:") == 1  # rank 0 alone prints
    assert "IMPORTED []" in text


def test_part2b_flags_are_exclusive():
    with pytest.raises(SystemExit, match="mutually exclusive"):
        part2b.main(TINY + ["--ring", "--bf16-grads"])


def test_parts_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for main in (part1.main, part3.main):
        with pytest.raises(SystemExit, match="card.*--device cpu"):
            main(["--synthetic-train-size", "16"])


LATER_FLAGS = [
    (["--verify-replicas"], None),
    (["--flight-dir", "fd"], None),
    (["--metrics-port", "0"], None),
    (["--profile-dir", "pd"], None),
]


@pytest.mark.parametrize("flags,item", LATER_FLAGS,
                         ids=[f[0].lstrip("-") for f, _ in LATER_FLAGS])
def test_later_slice_flags_name_their_roadmap_item(flags, item, tmp_path,
                                                   monkeypatch, capsys):
    """A flag of a later slice exits naming its ROADMAP item; every one
    here (item None) is ported and runs: ``--verify-replicas`` checks the
    replicas after the epoch (at one rank, JAX's "nothing to check"
    line), ``--profile-dir`` leaves a Chrome trace, ``--metrics-port``
    serves the trainer's metrics, ``--flight-dir`` is the trainer's
    flight directory."""
    if item is not None:
        with pytest.raises(SystemExit, match=f"ROADMAP.md {item}"):
            part1.main(TINY + flags)
        return
    monkeypatch.chdir(tmp_path)
    small = ["--device", "cpu", "--synthetic-train-size", "16",
             "--synthetic-test-size", "8", "--batch-size", "8"]
    trainer = part1.main(small + flags)
    out = capsys.readouterr().out
    assert "Test set:" in out
    if flags[0] == "--profile-dir":
        [trace] = os.listdir(tmp_path / "pd")
        assert trace.startswith("trace-") and json.load(
            open(tmp_path / "pd" / trace))["traceEvents"]
    if flags[0] == "--metrics-port":
        assert re.search(r"metrics endpoint: http://127\.0\.0\.1:\d+/metrics",
                         out)
    if flags[0] == "--verify-replicas":
        assert trainer.verify_replicas
        assert ("[tpudp] replica consistency: nothing to check (no leaf "
                "has >1 replica on this mesh)") in out
    if flags[0] == "--flight-dir":
        assert trainer.flight.directory == "fd"
        assert trainer.flight.dump("probe") is not None
        assert os.listdir(tmp_path / "fd")


# The JAX CLI's validation of the checkpoint and supervisor flags
# (tpudp/cli.py), before any data or model is built.
CHECKPOINT_FLAG_ERRORS = [
    (["--eval-only"], "--eval-only requires --checkpoint-dir"),
    (["--checkpoint-async"], "--checkpoint-async requires --checkpoint-dir"),
    (["--keep-checkpoints", "2"], "--keep-checkpoints requires"),
    (["--resilience"], "--resilience requires --checkpoint-dir"),
    (["--checkpoint-dir", "ck", "--keep-checkpoints", "0"],
     "--keep-checkpoints must be >= 1"),
    (["--checkpoint-dir", "ck", "--max-rollbacks", "2"],
     "pass --resilience too"),
    (["--checkpoint-dir", "ck", "--resilience", "--spike-factor", "0.5"],
     "--spike-factor must be > 1.0"),
    (["--step-timeout", "0"], "--step-timeout must be > 0"),
]


@pytest.mark.parametrize("flags,message", CHECKPOINT_FLAG_ERRORS,
                         ids=["-".join(f).lstrip("-")
                              for f, _ in CHECKPOINT_FLAG_ERRORS])
def test_checkpoint_flags_are_validated(flags, message):
    with pytest.raises(SystemExit, match=message):
        part1.main(TINY + flags)


def test_spmd_mode_is_part3s_and_sync_bn_needs_shard_map():
    """--spmd-mode belongs to Part 3; --sync-bn needs ranks sharing
    statistics by hand: not Part 1, not gspmd (already global)."""
    with pytest.raises(SystemExit, match="only to the Part 3"):
        part2b.main(TINY + ["--spmd-mode", "shard_map"])
    with pytest.raises(SystemExit, match="--sync-bn needs a shard_map"):
        part1.main(TINY + ["--sync-bn"])
    with pytest.raises(SystemExit, match="--sync-bn needs a shard_map"):
        part3.main(TINY + ["--sync-bn", "--spmd-mode", "gspmd"])


# -- the Trainer against the JAX Trainer -----------------------------------

NARROW = (8, "M", 16, "M", "M", "M", "M")


def _loaders(make_loader, make_sampler, train_set, test_set):
    return (make_loader(train_set, 8,
                        sampler=make_sampler(len(train_set.images), 1, 0,
                                             shuffle=True, seed=3),
                        train=True, seed=3),
            make_loader(test_set, 8,
                        sampler=make_sampler(len(test_set.images), 1, 0,
                                             shuffle=False), train=False))


@pytest.mark.parametrize("timing_mode", ["fused", "split"])
def test_trainer_matches_the_jax_trainer(tmp_path, timing_mode):
    """One epoch of 8 iterations, windows of 2, then the eval over a
    ragged test set: the window losses and the eval's loss and accuracy
    equal the JAX Trainer's on the same weights and batches; the lines
    are the reference's (split mode adds the forward/backward lines)."""
    train_set, test_set, _ = load_cifar10(str(tmp_path),
                                          synthetic_train_size=64,
                                          synthetic_test_size=20)
    params, stats = vgg.random_params(NARROW, 9)
    jax_lines, lines = [], []
    jt = JaxTrainer(JaxVGG(cfg=NARROW), None, "none", log_every=2,
                    timing_mode=timing_mode, log_fn=jax_lines.append,
                    metrics_jsonl=str(tmp_path / "jax.jsonl"))
    p = jax.tree.map(jnp.asarray, params)
    jt.state = jt.state.replace(params=p,
                                batch_stats=jax.tree.map(jnp.asarray, stats),
                                opt_state=jt.tx.init(p))
    jt.fit(*_loaders(JaxLoader, JaxSampler, train_set, test_set))
    model = vgg.VGG(NARROW)
    model.load_state_dict(vgg.params_from_jax(params, stats))
    trainer = Trainer(model, log_every=2, timing_mode=timing_mode,
                      log_fn=lines.append,
                      metrics_jsonl=str(tmp_path / "port.jsonl"))
    trainer.fit(*_loaders(DataLoader, ShardedSampler, train_set, test_set))
    want = [json.loads(x) for x in open(tmp_path / "jax.jsonl")]
    got = [json.loads(x) for x in open(tmp_path / "port.jsonl")]
    assert got == trainer.records
    assert [r["kind"] for r in got] == [r["kind"] for r in want] == [
        "train_window"] * 4 + ["epoch", "eval"]
    np.testing.assert_allclose([r["loss"] for r in got[:4]],
                               [r["loss"] for r in want[:4]], rtol=1e-5)
    assert [r["warmup_window"] for r in got[:4]] == [True] + [False] * 3
    np.testing.assert_allclose(got[-1]["avg_loss"], want[-1]["avg_loss"],
                               rtol=1e-5)
    assert got[-1]["count"] == want[-1]["count"] == 20
    assert got[-1]["accuracy"] == want[-1]["accuracy"]
    def shape(text):  # the line with its numbers masked
        return re.sub(r"\d[\d.e-]*", "#", text)

    assert [shape(x) for x in lines] == [shape(x) for x in jax_lines]
    assert any(x.startswith("Forward Pass time") for x in lines) == (
        timing_mode == "split")
    assert trainer.metrics()["step"] == 8


def test_trainer_refuses_unported_options():
    model = vgg.VGG(NARROW)
    # the robustness options (once refused) construct as JAX's do: the
    # fingerprint slot is JAX's (2,) of zeros, the hook is kept
    from tpudp.models.vgg import VGG as JaxVGG
    from tpudp.train import Trainer as JaxTrainer

    jt = JaxTrainer(JaxVGG(cfg=NARROW), None, verify_replicas=True,
                    track_sdc_fingerprint=True, sdc_fault_hook=print)
    tr = Trainer(model, verify_replicas=True, track_sdc_fingerprint=True,
                 sdc_fault_hook=print)
    assert tr.verify_replicas and tr.sdc_fault_hook is print
    np.testing.assert_array_equal(tr.state.sdc_fp.numpy(),
                                  np.asarray(jt.state.sdc_fp))
    # the obs layer is ported: a flight directory and the grad-norm
    # accumulator construct and are kept
    tr = Trainer(model, flight_dir="x", track_grad_norm=True)
    assert tr.flight.directory == "x" and tr.state.obs_norms is not None
    # strategies are ported: tp needs a mesh; the VGG and the ResNet
    # train under the VGG's TP rules
    with pytest.raises(ValueError, match="needs a device mesh"):
        Trainer(model, strategy="tp")
    from tpudp_torch.mesh import MeshND
    from tpudp_torch.models import resnet
    from tpudp_torch.parallel.tensor import vgg_tp_rules

    mesh = MeshND(shape={"data": 1, "model": 2}, rank=0,
                  coords={"data": 0, "model": 0},
                  groups={"data": None, "model": None})
    tp = Trainer(model, mesh, strategy="tp",
                 strategy_options={"rules": vgg_tp_rules()})
    assert tuple(tp.state.model.convs[0].weight.shape) == (4, 3, 3, 3)
    tp = Trainer(resnet.ResNet((1, 1), 10, 16), mesh, strategy="tp",
                 strategy_options={"rules": vgg_tp_rules()})
    assert tuple(tp.state.model.stem_conv.weight.shape) == (8, 3, 7, 7)
    with pytest.raises(ValueError, match="spmd_mode"):
        Trainer(model, spmd_mode="auto")
    with pytest.raises(ValueError, match="shard_map DP rung"):
        Trainer(model, Mesh(size=1, rank=0), "none", compress="int8_ef",
                spmd_mode="gspmd")
    with pytest.raises(TypeError, match="unexpected keyword"):
        Trainer(model, flux=1)
    with pytest.raises(ValueError, match="mesh"):
        Trainer(model, sync="none", compress="int8_ef")
    assert Trainer(model, sdc_fault_hook=print).state.sdc_fp is None
