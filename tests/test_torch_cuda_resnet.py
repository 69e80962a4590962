"""The slice of the native loader, SyncBN, GSPMD and ResNet on the card.
Every test carries the ``cuda`` marker and skips without a card.  The
file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_resnet.py -q
"""

import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpudp_torch import train, train_resnet
from tpudp_torch.data import DataLoader, device_place
from tpudp_torch.data.cifar10 import Dataset
from tpudp_torch.mesh import initialize_distributed, make_mesh
from tpudp_torch.models import resnet, vgg

VGG11 = vgg.CONFIGS["VGG11"]


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


def _batch(seed, n=32, size=32, classes=10):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(n, size, size, 3)).astype(
                np.float32), device="cuda"),
            torch.as_tensor(rng.integers(0, classes, size=n), device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sync_bn", "gspmd"])
def test_cross_rank_batchnorm_over_nccl_at_world_1(nccl_world, mode):
    """At one rank, SyncBN (statistics all-reduced over NCCL, E[x^2] -
    E[x]^2) and the GSPMD step take the local step's loss; the weights
    part only by the two variance formulas' rounding."""
    x, y = _batch(1)
    out = {}
    for case in ("local", mode):
        model = vgg.build(VGG11, 0, "cuda",
                          bn_axis="data" if case == "sync_bn" else None)
        spec = train.make_optimizer(learning_rate=0.01)
        state = train.init_state(model, spec, nccl_world)
        step = train.make_train_step(
            model, spec, nccl_world, "auto" if case == "gspmd" else
            "allreduce", spmd_mode="gspmd" if case == "gspmd" else
            "shard_map")
        _, loss = step(state, x, y)
        out[case] = float(loss), model.state_dict()
    np.testing.assert_allclose(out[mode][0], out["local"][0], rtol=1e-5)
    for name, value in out["local"][1].items():
        torch.testing.assert_close(out[mode][1][name], value, rtol=1e-4,
                                   atol=1e-5, msg=name)


@pytest.mark.cuda
def test_resnet50_forward_matches_the_cpu(card):
    """ResNet-50 at 64x64, float32 logits on the card (TF32 off) against
    the CPU's, residual branches switched on (last BatchNorm scales 1)."""
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(4, 64, 64, 3)).astype(np.float32))
    cpu = resnet.build(50, 3, "cpu", num_classes=10)
    gpu = resnet.build(50, 3, "cuda", num_classes=10)
    for model in (cpu, gpu):
        for block in model.blocks:
            torch.nn.init.ones_(block.bns[2].weight)
    with torch.no_grad():
        want = cpu(x, train=True)
        got = gpu(x.cuda(), train=True).cpu()
    assert float((got - want).norm() / want.norm()) < 1e-4


@pytest.mark.cuda
def test_resnet50_bfloat16_forward_matches_the_cpu(card):
    """ResNet-50 at 64x64, batch 4, flax's init (each block's last
    BatchNorm scale zero): bfloat16 train-mode logits on the card against
    the CPU's float32 logits, within three times what bfloat16 rounding
    alone gives on the CPU (0.0103, tests/test_torch_resnet.py)."""
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(4, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        want = resnet.build(50, 3, "cpu")(x, train=True)
        got = resnet.build(50, 3, "cuda", dtype=torch.bfloat16)(
            x.cuda(), train=True).cpu()
    assert float((got - want).norm() / want.norm()) < 0.03


@pytest.mark.cuda
def test_bfloat16_forward_matches_the_cpu(card):
    """bfloat16 on the tiny ResNet of the CPU tests (two blocks, width 16,
    32x32, batch 8, every residual branch switched on) by the logits'
    relative error norm, as for VGG-11.  ResNet-50 with its branches on
    is rounding-bound in train mode (tests/test_torch_resnet.py), so it
    is held at flax's init above."""
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(8, 32, 32, 3)).astype(np.float32))
    params, stats = resnet.random_params((1, 1), 5, 10, 16)
    out = []
    for device in ("cpu", "cuda"):
        model = resnet.ResNet((1, 1), 10, 16, dtype=torch.bfloat16)
        model.load_state_dict(resnet.params_from_jax(params, stats))
        for block in model.blocks:
            torch.nn.init.ones_(block.bns[2].weight)
        model.to(device, memory_format=torch.channels_last)
        with torch.no_grad():
            out.append(model(x.to(device), train=True).cpu())
    assert float((out[1] - out[0]).norm() / out[0].norm()) < 1e-2


@pytest.mark.cuda
def test_native_loader_feeds_the_card(card):
    """Native batches at 224x224 reach the card through pinned memory
    equal to the numpy backend's."""
    rng = np.random.default_rng(0)
    ds = Dataset(rng.integers(0, 256, (8, 224, 224, 3), np.uint8),
                 rng.integers(0, 1000, 8).astype(np.int32))
    kw = dict(train=True, seed=0,
              mean=np.asarray(train_resnet.IMAGENET_MEAN, np.float32),
              std=np.asarray(train_resnet.IMAGENET_STD, np.float32))
    place = device_place(card)
    native = DataLoader(ds, 4, backend="native", **kw)
    numpy = DataLoader(ds, 4, backend="numpy", **kw)
    assert native.backend == "native"
    for got, want in zip(native, numpy):
        images = place(got)[0]
        torch.cuda.synchronize()
        assert images.device.type == "cuda"
        np.testing.assert_array_equal(images.cpu().numpy(), want[0])


@pytest.mark.cuda
def test_train_resnet_runs_on_the_card_by_default(card, capsys):
    """No --device: ResNet-50 trains on the card on the native loader
    and prints the example's lines."""
    run = train_resnet.main(["--steps", "4", "--batch-size", "8",
                             "--train-size", "16", "--image-size", "64",
                             "--log-every", "2", "--num-classes", "10"])
    text = capsys.readouterr().out
    if dist.is_initialized():
        dist.destroy_process_group()
    assert "device=cuda" in text and "data=native" in text
    assert [int(i) for i in re.findall(r"^step (\d+): loss", text,
                                       re.M)] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in run["records"])
    assert next(run["model"].parameters()).device.type == "cuda"
