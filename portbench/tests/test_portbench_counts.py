"""The frozen counts and peaks against the program's own at small sizes,
and flash attention's bytes against the tensors its plain version
reads and writes."""

import pytest
import torch
from conftest import ROOT  # noqa: F401  (puts the checkout on sys.path)

from portbench.counts import flash, flops, peaks
from tpudp_torch.ops import flash_attention as fa
from tpudp_torch.utils import flops as prog_flops


@pytest.mark.parametrize("batch", [1, 4, 256])
def test_vgg_count_is_the_programs(batch):
    assert flops.vgg_fwd_flops(batch, flops.VGG_LAYERS["VGG11"]) == \
        prog_flops.vgg_fwd_flops(batch, "VGG11")


@pytest.mark.parametrize("b,t,layers,d,v", [(2, 16, 2, 64, 256),
                                            (16, 1024, 12, 768, 50257)])
def test_gpt2_causal_count_halves_the_programs_square(b, t, layers, d, v):
    ours = flops.gpt2_fwd_flops_causal(b, t, num_layers=layers, d_model=d,
                                       vocab_size=v)
    theirs = prog_flops.gpt2_fwd_flops(b, t, num_layers=layers, d_model=d,
                                       vocab_size=v)
    # the program counts the score and value products over the whole
    # t x t square; causal attention needs half of it
    assert theirs - ours == layers * 2 * b * t * t * d


def test_gpt2_step_at_the_cell_shape():
    step = flops.train_step_flops(flops.gpt2_fwd_flops_causal(
        16, 1024, num_layers=12, d_model=768, vocab_size=50257))
    full = prog_flops.train_step_flops(prog_flops.gpt2_fwd_flops(
        16, 1024, num_layers=12, d_model=768, vocab_size=50257))
    assert step == pytest.approx(13.07e12, rel=1e-3)
    assert full == pytest.approx(14.00e12, rel=1e-3)


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe",
                                  "NVIDIA H100 SXM5 80GB"])
def test_peaks_are_the_programs(name):
    assert peaks.peaks(name)[0] == prog_flops.chip_peak_flops(name)


def test_unknown_card_has_no_peak():
    assert peaks.peaks("cpu") is None


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bytes_are_the_tensors_read_and_written(dtype):
    b, t, h, dh = 2, 32, 3, 16
    q, k, v = (torch.randn(b, t, h, dh).to(dtype) for _ in range(3))
    o, lse = fa.flash_fwd(q, k, v, causal=True)  # the plain version on CPU
    do = torch.randn_like(o)
    dq, dk, dv = fa._flash_bwd_plain(q, k, v, o, lse, do, True)
    elem = q.element_size()
    assert flash.forward(b, t, h, dh, elem)[1] == _nbytes(q, k, v, o, lse)
    assert flash.backward(b, t, h, dh, elem)[1] == _nbytes(
        q, k, v, o, do, lse, dq, dk, dv)


def test_flash_operations_count_the_causal_pairs():
    b, t, h, dh = 2, 8, 3, 4
    mask = torch.ones(t, t).tril()
    pairs = int(mask.sum())
    assert flash.causal_pairs(t) == pairs
    product = 2 * b * h * dh * pairs  # one product over the kept pairs
    assert flash.forward(b, t, h, dh, 2)[0] == 2 * product
    assert flash.backward(b, t, h, dh, 2)[0] == 4 * product
