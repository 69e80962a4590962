"""``tpudp_torch.utils.flops`` against ``tpudp.utils.flops``: every
analytic count equals JAX's on the same arguments, the bubble fraction
too, the H100 peaks are NVIDIA's dense bf16 figures, and
``counted_flops`` (``FlopCounterMode``) of the port's VGG-11 and tiny
ResNet forwards equals the analytic count on the CPU."""

import pytest
import torch

from tpudp.utils import flops as jax_flops
from tpudp_torch.models import resnet, vgg
from tpudp_torch.utils import flops, timing


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = [
    ("conv2d_flops", (8, 16, 16, 3, 64, 3, 3), {}),
    ("dense_flops", (8, 512, 10), {}),
    ("vgg_fwd_flops", (32,), {}),
    ("vgg_fwd_flops", (4, "VGG16", 64, 100), {}),
    ("resnet_fwd_flops", (8,), {}),
    ("resnet_fwd_flops", (2, (1, 1), 32, 10, 16), {}),
    ("resnet_fwd_flops", (4, (3, 4, 23, 3)), {}),
    ("gpt2_fwd_flops", (8, 1024), {}),
    ("gpt2_fwd_flops", (2, 32), dict(num_layers=2, d_model=32,
                                     vocab_size=64, mlp_ratio=4)),
    ("llama_fwd_flops", (4, 128), dict(num_layers=2, d_model=192,
                                       vocab_size=256, hidden=512,
                                       num_heads=6, kv_heads=3)),
    ("train_step_flops", (123_456,), {}),
]


@pytest.mark.parametrize("name,args,kwargs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_analytic_counts_equal_jax(name, args, kwargs):
    assert getattr(flops, name)(*args, **kwargs) == \
        getattr(jax_flops, name)(*args, **kwargs)


@pytest.mark.parametrize("stages,m,v", [(1, 4, 1), (2, 4, 1), (4, 8, 2),
                                        (2, 2, 2)])
def test_bubble_fraction_equals_jax(stages, m, v):
    from tpudp_torch.parallel import schedule

    assert flops.pipeline_bubble_fraction(stages, m, v) == \
        jax_flops.pipeline_bubble_fraction(stages, m, v)
    assert schedule.pipeline_bubble_fraction is flops.pipeline_bubble_fraction
    with pytest.raises(ValueError):
        flops.pipeline_bubble_fraction(stages, 0)


def test_chip_peak_and_mfu():
    assert flops.chip_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert flops.chip_peak_flops("NVIDIA H100 SXM5 80GB") == 989.4e12
    assert flops.chip_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert flops.chip_peak_flops("cpu") is None
    assert flops.mfu(989.4e12, 1.0, "NVIDIA H100 80GB HBM3") == 1.0
    assert flops.mfu(1e12, 0.5, "NVIDIA H100 PCIe", n_devices=2) == \
        pytest.approx(1e12 / (0.5 * 2 * 756e12))
    assert flops.mfu(1e12, 1.0, "cpu") is None
    assert flops.mfu(1e12, 0.0, "NVIDIA H100 PCIe") is None
    assert timing.StepTimer is __import__(
        "tpudp_torch.obs.timing", fromlist=["StepTimer"]).StepTimer


def test_counted_flops_equal_analytic_on_cpu():
    x = torch.zeros(2, 32, 32, 3)
    net = vgg.VGG(vgg.CONFIGS["VGG11"])
    assert flops.counted_flops(net, x) == flops.vgg_fwd_flops(2)
    tiny = resnet.ResNet((1, 1), 10, 16)
    assert flops.counted_flops(tiny, x) == flops.resnet_fwd_flops(
        2, (1, 1), 32, 10, 16)
