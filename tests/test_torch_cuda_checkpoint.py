"""Checkpoints, resume and the supervisor on the card.  Every test carries
the ``cuda`` marker and skips without a card.  The file imports no JAX,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_checkpoint.py -q

The CPU tests (``tests/test_torch_checkpoint.py``,
``test_torch_resilience.py``) hold the same paths to the JAX package;
here the state lives on the card: the asynchronous writer's pinned,
stream-ordered snapshot, a restore onto the card, bit-exact resume and
recovery under deterministic cuDNN, and ``skip_nonfinite`` with AdamW's
count on the device.
"""

import os

import numpy as np
import pytest
import torch

from tpudp_torch import train
from tpudp_torch.data import (DataLoader, Prefetcher, ShardedSampler,
                              device_place, load_cifar10)
from tpudp_torch.models import vgg
from tpudp_torch.resilience import ResiliencePolicy
from tpudp_torch.trainer import Trainer
from tpudp_torch.training_faults import RaisingStep
from tpudp_torch.utils import checkpoint as ck

NARROW = (8, "M", 16, "M", "M", "M", "M")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the state lives on the device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = False


def _state(optimizer="sgd", **kw):
    model = vgg.build(NARROW, 3, "cuda")
    return train.init_state(model, train.make_optimizer(
        learning_rate=0.01, optimizer=optimizer, **kw))


def _batch(seed, n=16):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(n, 32, 32, 3)).astype(
                np.float32), device="cuda"),
            torch.as_tensor(rng.integers(0, 10, size=n), device="cuda"))


@pytest.mark.cuda
def test_async_snapshot_is_taken_before_the_next_step(card, tmp_path):
    """The writer's copies are queued before the next step's update on the
    same stream, so the checkpoint holds the state as it was at
    ``save()`` though the step runs at once; a restore brings it back
    onto the card bit for bit."""
    state = _state()
    step = train.make_train_step(state.model, train.make_optimizer(
        learning_rate=0.01))
    state, _ = step(state, *_batch(1))
    frozen = {k: v.clone() for k, v in state.model.state_dict().items()}
    with ck.AsyncCheckpointWriter() as writer:
        writer.save(tmp_path / "step_1", state)
        state, _ = step(state, *_batch(2))  # updates in place at once
    fresh = _state()
    ck.restore_checkpoint(tmp_path / "step_1", fresh, verify=True)
    assert fresh.step == 1
    for k, v in fresh.model.state_dict().items():
        assert v.device.type == "cuda" and torch.equal(v, frozen[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_resume_continues_the_trajectory_on_the_card(card, tmp_path,
                                                     optimizer):
    """Three steps uninterrupted equal two, a checkpoint, a fresh state
    and a third, bit for bit (momentum or AdamW's moments and count)."""
    runs = []
    for resume in (False, True):
        state = _state(optimizer)
        spec = train.make_optimizer(learning_rate=0.01, optimizer=optimizer)
        step = train.make_train_step(state.model, spec)
        for i in range(2):
            state, _ = step(state, *_batch(i))
        if resume:
            ck.save_checkpoint(tmp_path / optimizer / "step_2", state)
            state = _state(optimizer)
            step = train.make_train_step(state.model, spec)
            ck.restore_checkpoint(tmp_path / optimizer / "step_2", state,
                                  verify=True)
        state, _ = step(state, *_batch(2))
        runs.append({k: v.clone()
                     for k, v in state.model.state_dict().items()})
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


@pytest.mark.cuda
def test_supervised_step_fault_recovers_bit_exact(card, tmp_path):
    """A raising step on the card: the supervisor fences, dumps, restores
    and ends bit-equal to an uninterrupted run."""
    train_set, _, _ = load_cifar10(str(tmp_path / "none"),
                                   synthetic_train_size=128,
                                   synthetic_test_size=16)
    finals = []
    for hook in (None, RaisingStep(fail_at={6})):
        loader = Prefetcher(DataLoader(
            train_set, 32, sampler=ShardedSampler(128, 1, 0, shuffle=True,
                                                  seed=1),
            train=True, seed=1), depth=2, place=device_place("cuda"))
        tr = Trainer(vgg.build(NARROW, 3, "cuda"), learning_rate=0.01,
                     log_every=2, log_fn=lambda line: None,
                     step_fault_hook=hook)
        root = str(tmp_path / ("clean" if hook is None else "fault"))
        tr.fit(loader, epochs=2,
               resilience=ResiliencePolicy(checkpoint_dir=root))
        loader.close()
        if hook is not None:
            assert tr.stats["step_retries"] == 1
            assert os.path.isdir(os.path.join(root, "emergency.restored"))
        finals.append({k: v.clone()
                       for k, v in tr.model.state_dict().items()})
    for k in finals[0]:
        assert torch.equal(finals[0][k], finals[1][k]), k


@pytest.mark.cuda
def test_skip_nonfinite_adamw_keeps_its_count_on_the_card(card):
    """AdamW under ``skip_nonfinite`` keeps its count on the device
    (capturable): a NaN batch leaves params, moments and count as they
    were, with no host read deciding it."""
    state = _state("adamw", skip_nonfinite=2)
    spec = train.make_optimizer(learning_rate=0.01, optimizer="adamw",
                                skip_nonfinite=2)
    step = train.make_train_step(state.model, spec)
    state, _ = step(state, *_batch(0))
    before = {k: v.clone() for k, v in state.model.named_parameters()}
    p0 = next(state.model.parameters())
    count = state.optimizer.state[p0]["step"].clone()
    assert count.device.type == "cuda"
    x, y = _batch(1)
    state, _ = step(state, x * float("nan"), y)
    assert int(state.skip["notfinite_count"]) == 1
    assert torch.equal(state.optimizer.state[p0]["step"], count)
    for k, v in state.model.named_parameters():
        assert torch.equal(v, before[k]), k
