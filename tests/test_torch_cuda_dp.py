"""The data-parallel VGG path on the card: VGG-11 at full width, world
size 1 over NCCL.  Every test carries the ``cuda`` marker and skips
without a card.  The file imports no JAX, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_dp.py -q
"""

import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpudp_torch import train
from tpudp_torch.data import device_place
from tpudp_torch.mesh import initialize_distributed, make_mesh
from tpudp_torch.models import vgg
from tpudp_torch.parts import part2b

VGG11 = vgg.CONFIGS["VGG11"]
RUNGS = ("none", "coordinator", "allreduce", "allreduce_bf16",
         "allreduce_int8", "ring", "ring_uni", "ring_bidir", "allreduce_hd",
         "allreduce_a2a", "auto")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and cuDNN run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def nccl_world(card):
    """An NCCL group of this process alone, taken down after the test."""
    owned = not dist.is_initialized()
    initialize_distributed(card)
    yield make_mesh()
    if owned:
        dist.destroy_process_group()


def _batch(seed, n=32):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(n, 32, 32, 3)).astype(
                np.float32), device="cuda"),
            torch.as_tensor(rng.integers(0, 10, size=n), device="cuda"))


def _one_step(mesh, sync, dtype=torch.float32, compress=None):
    model = vgg.build(VGG11, 0, "cuda", dtype=dtype)
    spec = train.make_optimizer(learning_rate=0.01, compress=compress)
    state = train.init_state(model, spec, mesh)
    step = train.make_train_step(model, spec, mesh, sync)
    x, y = _batch(1)
    state, loss = step(state, x, y)
    return float(loss), model.state_dict()


@pytest.mark.cuda
@pytest.mark.parametrize("sync", RUNGS)
def test_vgg11_rung_at_world_1_on_the_card(nccl_world, sync):
    """One VGG-11 step with each rung at world size 1: the loss equals the
    unsynchronized step's, and so do the weights but for bf16's rounding
    (cuDNN may pick kernels that sum in other orders between runs)."""
    want_loss, want = _one_step(None, "none")
    loss, got = _one_step(nccl_world, sync)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    tol = (dict(rtol=2e-2, atol=2e-3) if sync == "allreduce_bf16"
           else dict(rtol=1e-4, atol=1e-6))
    for name, value in want.items():
        torch.testing.assert_close(got[name], value, **tol, msg=name)


@pytest.mark.cuda
def test_int8_error_feedback_at_world_1(nccl_world):
    loss, got = _one_step(nccl_world, "none", compress="int8_ef")
    want_loss, want = _one_step(None, "none")
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    # One step moves the weights by 0.01 x the gradient, quantized on a
    # 127-level grid of its largest value.
    diff = max(float((got[k] - want[k]).abs().max()) for k in want)
    assert 0 < diff < 1e-2


@pytest.mark.cuda
def test_vgg11_forward_matches_the_cpu(card):
    """Float32 logits on the card (TF32 off) against the CPU's, element
    by element.  In bfloat16 each of the 9 layers rounds its output to
    bf16 (2**-8 relative) after summing in another order than the CPU,
    so single logits can part by several ulps: the logits' relative
    error norm is held to 1e-2 instead."""
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(16, 32, 32, 3)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        cpu = vgg.build(VGG11, 3, "cpu", dtype=dtype)
        gpu = vgg.build(VGG11, 3, "cuda", dtype=dtype)
        with torch.no_grad():
            want = cpu(x, train=True)
            got = gpu(x.cuda(), train=True).cpu()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(gpu.bns[7].running_var.cpu(),
                                       cpu.bns[7].running_var, rtol=1e-3,
                                       atol=1e-5)
        else:
            assert float((got - want).norm() / want.norm()) < 1e-2


@pytest.mark.cuda
def test_device_place_copies_through_pinned_memory(card):
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    (t,) = device_place(card)((a,))
    torch.cuda.synchronize()
    assert t.device.type == "cuda"
    np.testing.assert_array_equal(t.cpu().numpy(), a)


@pytest.mark.cuda
def test_part2b_ring_runs_on_the_card_by_default(card, capsys):
    """No --device: the Part runs on the card and prints the reference's
    lines (40 iterations of VGG-11 at batch 16)."""
    part2b.main(["--ring", "--synthetic-train-size", "640",
                 "--synthetic-test-size", "64", "--batch-size", "16"])
    text = capsys.readouterr().out
    if dist.is_initialized():
        dist.destroy_process_group()
    assert "device=cuda" in text
    assert re.findall(r"^Training loss after (\d+) iterations", text,
                      re.M) == ["20", "40"]
    assert re.search(r"^Test set: Average loss: [\d.]+, Accuracy: \d+/64",
                     text, re.M)
